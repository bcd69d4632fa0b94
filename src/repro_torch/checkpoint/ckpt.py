"""Fault-tolerant checkpoints with GBDI compression.

PyTorch counterpart of ``src/repro/checkpoint/ckpt.py``, on the same on-disk
format, so a checkpoint written by either package loads in the other.
Checkpoints are memory dumps in the paper's sense (parameters, float32
optimizer moments, step counters) and compress with the GBDI host codec:
one global base table per word size is fitted across the whole checkpoint
from the first 2^14 words of every leaf of that size.

Format, as the reference writes it:

* atomic: written to ``<dir>/tmp.<step>``, renamed to ``step_<step>``, then
  ``LATEST`` is replaced; a crash at any point leaves a valid tree;
* ``manifest.json`` holds ``{"step", "leaves": {key: {"shape", "dtype",
  "file", "codec"}}}``, keys the leaves' ``/``-joined tree paths (dict keys
  sorted);
* one ``.npz`` a leaf: ``ptr``, ``payload``, ``bases``, ``widths`` and
  ``meta`` (``[n_words, word_bits]``) for a ``gbdi`` leaf, kept where GBDI
  stores under 95 % of a leaf past 4,096 bytes, else ``raw`` (bf16 as its
  uint16 bit pattern).

The fit and the encode (and on load the decode) run on the device where
the leaves live, through :mod:`repro_torch.core.gbdi`; only the ``.npz``
reads and writes are host work.  ``load(..., shardings=)`` takes a device,
or a tree of devices, to place the leaves on (a leaf goes to its template
leaf's device otherwise), or, as the reference takes mesh shardings, a
``(device_mesh, spec_tree)`` pair that returns DTensors placed by the specs
of :mod:`repro_torch.distributed.sharding`.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch._tree import path_str, tree_flatten_with_path, tree_map
from repro_torch.core import gbdi

#: leaves this many bytes or fewer are stored raw
MIN_COMPRESS_BYTES = 4096
#: words a leaf gives the fit's sample
SAMPLE_WORDS = 1 << 14


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of the leaf's dtype ("bfloat16", "float32", ...)."""
    return str(t.dtype).removeprefix("torch.")


def _word_bits(itemsize: int) -> int:
    return 16 if itemsize == 2 else 32


def _widths(wb: int) -> tuple[int, ...]:
    return (4, 8) if wb == 16 else (4, 8, 16, 24)


def leaf_words(t: torch.Tensor, word_bits: int) -> torch.Tensor:
    """The leaf's bytes as the codec's (n_words,) int32 word stream on its
    device: :func:`gbdi.words_to_signed` of :func:`gbdi.to_words` (16-bit
    words zero-extended, the last word zero-padded)."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    wbytes = word_bits // 8
    pad = (-raw.numel()) % wbytes
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    if word_bits == 16:
        return raw.view(torch.int16).to(torch.int32) & 0xFFFF
    return raw.view(torch.int32)


def _words_to_leaf(words: torch.Tensor, word_bits: int, dtype: torch.dtype,
                   shape: tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`leaf_words`."""
    if word_bits == 16:
        words = (((words + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    raw = words.contiguous().view(torch.uint8)
    nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
    return raw[:nbytes].view(dtype).reshape(shape)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy, two-byte floats as their uint16 bit pattern (npz
    cannot hold bf16), as the reference stores them."""
    t = t.detach().cpu()
    if t.element_size() == 2 and t.is_floating_point():
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    if arr.dtype == np.uint16:              # a two-byte float's bit pattern
        return torch.from_numpy(arr.view(np.int16)).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(arr)).view(dtype)


def _flatten(tree: Any) -> dict[str, torch.Tensor]:
    return {path_str(path): leaf for path, leaf in tree_flatten_with_path(tree)}


def _fit_models(flat: dict[str, torch.Tensor]) -> dict[int, gbdi.GBDIModel]:
    """One GBDI model per word size, fitted on the device of the leaves from
    the first :data:`SAMPLE_WORDS` words of each leaf of that size."""
    leaves = list(flat.values())
    dev = leaves[0].device if leaves else torch.device("cpu")
    models = {}
    for wb in (16, 32):
        parts = [leaf_words(v, wb)[:SAMPLE_WORDS].to(dev) for v in leaves
                 if _word_bits(v.element_size()) == wb]
        sample = torch.cat(parts) if parts else torch.zeros(16, dtype=torch.int32, device=dev)
        models[wb] = gbdi.fit(sample, gbdi.GBDIConfig(word_bits=wb, width_set=_widths(wb)))
    return models


def save(ckpt_dir: str | Path, step: int, tree: Any, *, compress: bool = True) -> dict:
    """Write ``tree`` as ``step_<step>``; returns ``{"ratio", "bytes_raw",
    "bytes_stored"}``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    flat = _flatten(tree)
    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    bytes_raw = bytes_stored = 0
    models = _fit_models(flat) if compress else {}

    for key, t in flat.items():
        fname = key.replace("/", "__") + ".npz"
        raw = t.numel() * t.element_size()
        bytes_raw += raw
        entry = {"shape": list(t.shape), "dtype": _dtype_name(t), "file": fname}
        if compress and raw > MIN_COMPRESS_BYTES:
            wb = _word_bits(t.element_size())
            model = models[wb].to(t.device)
            blob = gbdi.encode(leaf_words(t, wb), model)
            stored = (gbdi.compressed_size_bits(blob) + 7) // 8
            if stored < raw * 0.95:
                np.savez(tmp / fname, ptr=blob["ptr_stream"].cpu().numpy(),
                         payload=blob["payload_stream"].cpu().numpy(),
                         bases=model.bases.cpu().numpy(), widths=model.widths.cpu().numpy(),
                         meta=np.array([blob["n_words"], wb], np.int64))
                entry["codec"] = "gbdi"
                bytes_stored += stored
                manifest["leaves"][key] = entry
                continue
        np.savez(tmp / fname, raw=_to_numpy(t))
        entry["codec"] = "raw"
        bytes_stored += raw
        manifest["leaves"][key] = entry

    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = ckpt_dir / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    (ckpt_dir / "LATEST.tmp").write_text(str(step))
    os.replace(ckpt_dir / "LATEST.tmp", ckpt_dir / "LATEST")
    return {"ratio": bytes_raw / max(bytes_stored, 1), "bytes_raw": bytes_raw,
            "bytes_stored": bytes_stored}


def latest_step(ckpt_dir: str | Path) -> int | None:
    f = Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    step = int(f.read_text().strip())
    return step if (Path(ckpt_dir) / f"step_{step}" / "manifest.json").exists() else None


def _load_leaf(d: Path, entry: dict, dev: torch.device) -> torch.Tensor:
    shape = tuple(entry["shape"])
    with np.load(d / entry["file"]) as z:
        if entry["codec"] == "gbdi":
            n_words, wb = (int(x) for x in z["meta"])
            blob = {
                "ptr_stream": torch.from_numpy(z["ptr"]).to(dev),
                "payload_stream": torch.from_numpy(z["payload"]).to(dev),
                "bases": torch.from_numpy(z["bases"].astype(np.int32)).to(dev),
                "widths": torch.from_numpy(z["widths"].astype(np.int32)).to(dev),
                "n_words": n_words,
                "config": gbdi.GBDIConfig(word_bits=wb, width_set=_widths(wb)),
            }
            return _words_to_leaf(gbdi.decode(blob), wb, getattr(torch, entry["dtype"]), shape)
        return _from_numpy(z["raw"], entry["dtype"]).reshape(shape).to(dev)


def load(ckpt_dir: str | Path, template: Any, *, step: int | None = None,
         shardings: Any = None) -> tuple[int, Any]:
    """Restore into the structure of ``template`` (the latest step unless
    ``step`` is given).  ``shardings`` places the leaves, in their stored
    dtype: a device, a tree of devices matching ``template``, or a
    ``(device_mesh, spec_tree)`` pair, which reads each whole leaf and
    returns it as a DTensor placed by its spec
    (:func:`repro_torch.distributed.sharding.distribute_tree`).  Without it
    each leaf lands on its template leaf's device in its dtype."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    mesh_specs = _mesh_and_specs(shardings)
    if shardings is None:
        targets = tree_map(lambda t: None, template)
    elif isinstance(shardings, (str, torch.device)):
        targets = tree_map(lambda t: torch.device(shardings), template)
    elif mesh_specs is not None:
        targets = tree_map(lambda t: _mesh_device(mesh_specs[0]), template)
    else:
        targets = shardings
    paths = iter(path_str(p) for p, _ in tree_flatten_with_path(template))

    def leaf(t: Any, dev: Any) -> torch.Tensor:
        entry = manifest["leaves"][next(paths)]
        if dev is not None:
            return _load_leaf(d, entry, torch.device(dev))
        return _load_leaf(d, entry, t.device).to(dtype=t.dtype)

    tree = tree_map(leaf, template, targets)
    if mesh_specs is not None:
        from repro_torch.distributed.sharding import distribute_tree

        tree = distribute_tree(tree, *mesh_specs)
    return step, tree


def _mesh_and_specs(shardings: Any) -> tuple[Any, Any] | None:
    """``shardings`` as a ``(DeviceMesh, spec tree)`` pair, or None."""
    if not (isinstance(shardings, tuple) and len(shardings) == 2):
        return None
    from torch.distributed.device_mesh import DeviceMesh

    return shardings if isinstance(shardings[0], DeviceMesh) else None


def _mesh_device(mesh: Any) -> torch.device:
    """The device of this rank on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


__all__ = ["MIN_COMPRESS_BYTES", "SAMPLE_WORDS", "latest_step", "leaf_words", "load", "save"]
