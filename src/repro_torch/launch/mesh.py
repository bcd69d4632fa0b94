"""Production meshes and the H100 roofline constants.

PyTorch counterpart of :mod:`repro.launch.mesh`, whose constants are the
TPU v5e's.  The sharding rules (:mod:`repro_torch.distributed.sharding`) and
the dry-run (:mod:`repro_torch.launch.dryrun`) work from the mesh's axis
sizes alone (:func:`production_axis_sizes`), so they need no device.
:func:`make_production_mesh` builds the real ``DeviceMesh`` and is callable
only inside a ``torch.distributed`` world of the mesh's size.
"""
from __future__ import annotations

import math

#: dense bf16 tensor-core peak of one H100 SXM5 80 GB (NVIDIA H100 data
#: sheet; the 1,979 TFLOP/s figure assumes 2:4 sparsity), FLOP/s
PEAK_FLOPS_BF16 = 989.4e12
#: HBM3 bandwidth of one H100 SXM5 80 GB (NVIDIA H100 data sheet), B/s
HBM_BW = 3.35e12
#: one NDR 400 Gb/s InfiniBand port a GPU (the DGX H100 / SuperPOD layout:
#: eight ConnectX-7 ports a node, one a GPU), B/s.  A 16 x 16 mesh spans 32
#: nodes of 8 GPUs, so a ring over either axis crosses nodes on this link.
IB_NDR_BW_PER_GPU = 50e9
#: NVLink 4 of one H100 SXM5, one direction (900 GB/s both ways; NVIDIA
#: H100 data sheet), B/s: the rate of a ring kept inside one 8-GPU node
NVLINK_BW_PER_GPU = 450e9
#: the roofline's collective term: every ring is modelled on the slowest
#: link it crosses, one InfiniBand port a GPU (the counterpart of the
#: reference's "single-link ring assumption"); no axis of a 16 x 16 mesh
#: fits inside one node
RING_BW_PER_GPU = IB_NDR_BW_PER_GPU


def production_axis_sizes(multi_pod: bool = False) -> dict[str, int]:
    """``{"data": 16, "model": 16}``, or with a leading ``"pod": 2``."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_production_mesh(multi_pod: bool = False):
    """The production ``DeviceMesh`` (``init_device_mesh``); raises unless
    a ``torch.distributed`` world of exactly the mesh's size is running."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sizes = production_axis_sizes(multi_pod)
    n = math.prod(sizes.values())
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(f"the production mesh needs a world of {n} ranks, "
                           f"this process is in a world of {world}")
    return init_device_mesh("cuda", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


__all__ = ["HBM_BW", "IB_NDR_BW_PER_GPU", "NVLINK_BW_PER_GPU", "PEAK_FLOPS_BF16",
           "RING_BW_PER_GPU", "make_production_mesh", "production_axis_sizes"]
