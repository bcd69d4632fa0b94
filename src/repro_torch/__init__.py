"""GBDI-FR on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of :mod:`repro`: the same fixed-rate GBDI page
format, fitted base tables and eval harness, with hand-written CUDA
kernels for page encode and decode.  Module paths mirror ``repro`` so each
ported module sits at the path of the file it is held against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such request they raise (:func:`repro_torch._device.resolve_device`).
"""
