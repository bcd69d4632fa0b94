"""Hopper shared-memory and occupancy model of kernels A, B and C, and the
``smem-over-budget`` checker.

Counterpart of ``src/repro/analysis/pallas_cost.py`` (the reference's
static VMEM model of its three Pallas kernels and ``--vmem-report``).  None
of the reference's figures carries over: its 16 MiB budget is the TPU's.
On the H100 a block's dynamic shared memory may reach
:data:`~repro_torch.kernels.gbdi_encode.SMEM_LIMIT_BYTES` (227 KB), an SM
holds 228 KB of it with 1 KB reserved a block, 2,048 threads and 32 blocks.

* **Static tie.**  Every module under ``src/repro_torch/kernels/`` that
  launches a library kernel must define ``smem_bytes`` and call its
  ``check_smem`` before the launch in each function that launches; a
  launching module missing from :data:`KERNEL_MODULES` is a finding too.
* **The report** (:func:`cost_report`): one :class:`KernelCost` row for each
  kernel and representative config, with the module's own formula
  (``smem_bytes``, and for C the pass size ``pass_slots`` picks), the
  threads a block, and the blocks an SM holds by shared memory and threads
  alone.  A row over the limit, or with no block an SM, is a finding.
* **On the card** (:func:`on_card`): each row gains the library's own
  ``<name>_smem_bytes`` (it must equal the formula), the runtime's
  ``<name>_blocks_per_sm`` (registers counted too: the model's count must
  be at least it) and the registers a thread and spill bytes ``-Xptxas -v``
  reported for the instantiation the row launches.

``python -m repro_torch.analysis --smem-report FILE [--on-card]`` writes the
report.
"""
from __future__ import annotations

import ast
import ctypes
import dataclasses
import re
from typing import Any, Iterator

from repro_torch.analysis import _ast_util as U
from repro_torch.analysis.base import register
from repro_torch.analysis.finding import Finding
from repro_torch.analysis.project import Project, SourceFile

#: kernel modules the model knows, and the library each launches
KERNEL_MODULES = {
    "src/repro_torch/kernels/gbdi_encode.py": "gbdi_encode",
    "src/repro_torch/kernels/gbdi_decode.py": "gbdi_decode",
    "src/repro_torch/kernels/gbdi_paged_attn.py": "gbdi_paged_attn",
}
#: one H100 SM: shared memory (228 KB), the part the runtime reserves a
#: block, threads and resident blocks at most
SM_SMEM_BYTES = 233472
RESERVED_SMEM_BYTES = 1024
SM_MAX_THREADS = 2048
SM_MAX_BLOCKS = 32
#: the attention geometries the port serves (configs by name: n_kv heads,
#: head dim, query heads a KV head; deepseek-7b's 4,096-word row spans two
#: page slots, so its block holds a page's 16 heads), and phase 5's
#: 512-channel head
ATTN_ARCHS = ("llama3-405b", "mixtral-8x22b", "qwen3-moe-235b-a22b", "paligemma-3b",
              "musicgen-large", "deepseek-7b")
WIDE_HEAD = ("hd-512 head", 1, 512, 8)


@dataclasses.dataclass
class KernelCost:
    """One kernel at one config: the model's columns, then the card's."""

    module: str                    # repo-relative path of the wrapper
    kernel: str                    # library name (``csrc/<kernel>.cu``)
    config: str                    # label of the representative config
    smem_bytes: int                # the module's formula, at the pass it launches
    threads: int                   # threads a block
    limit_bytes: int               # dynamic shared memory a block may use
    iparams: list[int]             # the library's int parameters for this row
    entry: str                     # template instantiation ptxas names it by
    pass_slots: int | None = None  # C: page slots a pass (``pass_slots``)
    max_slots: int | None = None   # C: the most slots a pass that fit the limit
    max_slots_smem_bytes: int | None = None
    error: str | None = None
    # filled by :func:`on_card`
    lib_smem_bytes: int | None = None
    lib_max_slots_smem_bytes: int | None = None
    runtime_blocks: int | None = None
    registers: int | None = None
    spill_stores: int | None = None
    spill_loads: int | None = None

    @property
    def blocks_by_smem(self) -> int:
        """Blocks an SM holds by shared memory and threads alone."""
        if self.threads <= 0:
            return 0
        return min(SM_SMEM_BYTES // (self.smem_bytes + RESERVED_SMEM_BYTES),
                   SM_MAX_THREADS // self.threads, SM_MAX_BLOCKS)

    @property
    def problems(self) -> list[str]:
        out = [] if self.error is None else [self.error]
        if self.smem_bytes > self.limit_bytes:
            out.append(f"{self.smem_bytes} B of shared memory a block > {self.limit_bytes} B")
        if self.blocks_by_smem < 1:
            out.append("no block fits an SM")
        if self.lib_smem_bytes is not None and self.lib_smem_bytes != self.smem_bytes:
            out.append(f"the library sizes {self.lib_smem_bytes} B, the formula "
                       f"{self.smem_bytes} B")
        if (self.lib_max_slots_smem_bytes is not None
                and self.lib_max_slots_smem_bytes != self.max_slots_smem_bytes):
            out.append(f"at {self.max_slots} slots the library sizes "
                       f"{self.lib_max_slots_smem_bytes} B, the formula "
                       f"{self.max_slots_smem_bytes} B")
        if self.runtime_blocks is not None and self.runtime_blocks < 1:
            out.append(f"the runtime's occupancy query gave {self.runtime_blocks}")
        elif self.runtime_blocks is not None and self.blocks_by_smem < self.runtime_blocks:
            out.append(f"the model's {self.blocks_by_smem} blocks an SM < the "
                       f"runtime's {self.runtime_blocks}")
        return out

    @property
    def ok(self) -> bool:
        return not self.problems

    def to_json(self) -> dict[str, Any]:
        out = dataclasses.asdict(self)
        out.update(blocks_by_smem=self.blocks_by_smem, ok=self.ok, problems=self.problems)
        return out


# --------------------------------------------------------------------------
# the representative configs
# --------------------------------------------------------------------------


def codec_configs() -> list[tuple[str, Any]]:
    """(label, FRConfig) for kernels A and B: the 16- and 32-bit eval
    defaults, an adaptive two-profile config, and the gradient ring's."""
    from repro_torch.core.gbdi_fr import FRConfig
    from repro_torch.distributed.collectives import GRAD_FR
    from repro_torch.eval.codecs import default_config

    return [
        ("16-bit default", default_config(16)),
        ("32-bit default", default_config(32)),
        ("adaptive (192,1856)|(64,1024)",
         FRConfig(word_bits=16, page_words=2048, num_bases=14, width_set=(4, 8),
                  cap_profiles=((192, 1856), (64, 1024)), outlier_cap=64)),
        ("GRAD_FR", GRAD_FR),
    ]


def attn_geometries() -> list[tuple[str, Any, int, int, int]]:
    """(label, FRConfig, n_kv, hd, groups) for kernel C: ``KV_FR`` at the
    served configs' attention geometries and phase 5's 512-channel head."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kv_cache import KV_FR

    out = []
    for arch in ATTN_ARCHS:
        cfg = get_config(arch)
        out.append((arch, KV_FR, cfg.n_kv_heads, cfg.head_dim_, cfg.n_heads // cfg.n_kv_heads))
    label, n_kv, hd, groups = WIDE_HEAD
    out.append((label, KV_FR, n_kv, hd, groups))
    return out


# --------------------------------------------------------------------------
# the rows
# --------------------------------------------------------------------------


def _encode_entry(cfg: Any, threads: int, max_words: int, max_classes: int) -> str:
    """``encode_kernel<W, NF>`` as ``kernel_for`` picks it (mangled)."""
    w = -(-cfg.page_words // threads)
    words = next((x for x in (1, 2, 4, 8, 16, 32) if w <= x), max_words)
    nf = 1 if cfg.num_classes <= 2 else (max_classes + 1) // 2
    return f"encode_kernelILi{words}ELi{nf}EE"


def _attn_entry(cpl: int) -> str:
    """``attn_kernel<CPL, WIDE, false>`` as ``attn_kernel_for<false>`` picks
    it (mangled): the full-attention instantiation."""
    return f"attn_kernelILi{min(cpl, 8)}ELb{int(cpl > 8)}ELb0EE"


def _codec_rows() -> list[KernelCost]:
    from repro_torch.kernels import gbdi_decode as dec
    from repro_torch.kernels import gbdi_encode as enc

    rows = []
    for label, cfg in codec_configs():
        ip = enc.kernel_iparams(cfg, 1)
        err = None
        try:
            enc.check_smem(cfg)
        except ValueError as e:
            err = str(e)
        rows.append(KernelCost(
            module="src/repro_torch/kernels/gbdi_encode.py", kernel="gbdi_encode",
            config=label, smem_bytes=enc.smem_bytes(cfg), threads=enc.ENCODE_THREADS,
            limit_bytes=enc.SMEM_LIMIT_BYTES, iparams=ip,
            entry=_encode_entry(cfg, enc.ENCODE_THREADS,
                                enc.MAX_PAGE_WORDS // enc.ENCODE_THREADS, enc.MAX_CLASSES),
            error=err))
        err = None
        try:
            enc.check_smem(cfg, dec.smem_bytes(cfg))
        except ValueError as e:
            err = str(e)
        rows.append(KernelCost(
            module="src/repro_torch/kernels/gbdi_decode.py", kernel="gbdi_decode",
            config=label, smem_bytes=dec.smem_bytes(cfg), threads=32 * dec.block_warps(cfg),
            limit_bytes=enc.SMEM_LIMIT_BYTES, iparams=ip,
            entry=f"decode_kernelILi{cfg.num_classes}EE", error=err))
    return rows


def _attn_rows() -> list[KernelCost]:
    from repro_torch.kernels import gbdi_paged_attn as pa
    from repro_torch.kernels.gbdi_encode import SMEM_LIMIT_BYTES

    rows = []
    for label, cfg, n_kv, hd, groups in attn_geometries():
        geom = dict(n_kv=n_kv, hd=hd, groups=groups)
        n = pa.pass_slots(cfg, **geom)
        fits = [s for s in range(1, pa.MAX_PASS_SLOTS + 1)
                if pa.smem_bytes(cfg, **geom, n_slots=s) <= SMEM_LIMIT_BYTES]
        top = max(fits) if fits else 1
        rows.append(KernelCost(
            module="src/repro_torch/kernels/gbdi_paged_attn.py", kernel="gbdi_paged_attn",
            config=f"KV_FR x {label} (Kv {n_kv}, hd {hd}, G {groups})",
            smem_bytes=pa.smem_bytes(cfg, **geom, n_slots=max(n, 1)),
            threads=pa.ATTN_WARPS * 32, limit_bytes=SMEM_LIMIT_BYTES,
            iparams=pa.attn_iparams(cfg, **geom, pass_n=max(n, 1)),
            entry=_attn_entry(pa.channels_per_lane(hd)), pass_slots=n, max_slots=top,
            max_slots_smem_bytes=pa.smem_bytes(cfg, **geom, n_slots=top),
            error=None if n else "no pass of one page slot fits a block"))
    return rows


def cost_report(project: Project) -> list[KernelCost] | None:
    """Rows of every known kernel module present in ``project``; None when
    the kernel modules cannot import (no torch)."""
    present = {rel for rel in KERNEL_MODULES if rel in project.by_rel}
    if not present:
        return []
    try:
        rows = _codec_rows() + _attn_rows()
    except ImportError:                        # pragma: no cover - no torch
        return None
    return [r for r in rows if r.module in present]


def full_report() -> list[KernelCost]:
    """Every row, without a project (what ``chip_smoke.py`` checks)."""
    return _codec_rows() + _attn_rows()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """Mangled kernel name -> registers, spill stores and loads, from what
    ``nvcc -Xptxas -v`` printed."""
    out: dict[str, dict[str, int]] = {}
    cur: dict[str, int] | None = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
        m = _SPILLS.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
    return out


def on_card(rows: list[KernelCost], logs: dict[str, str] | None = None) -> list[KernelCost]:
    """Fill each row's card columns from the built libraries and
    ``logs`` (``-Xptxas -v`` by library; default: the reports saved at the
    last build, building first where none is saved).  Raises without a CUDA
    device: the columns are never quietly left out."""
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise RuntimeError("--on-card needs a CUDA device: the runtime's occupancy "
                           "and the libraries' shared-memory sizes are the card's")
    torch.cuda.init()
    logs = logs if logs is not None else _build.ptxas_logs()
    entries = {name: parse_ptxas(text) for name, text in logs.items()}
    for row in rows:
        lib = _build.load(row.kernel)
        ip = _build.int_array(row.iparams)
        row.lib_smem_bytes = int(getattr(lib, f"{row.kernel}_smem_bytes")(ip))
        if row.max_slots is not None:
            top = _build.int_array(row.iparams[:-1] + [row.max_slots])
            row.lib_max_slots_smem_bytes = int(getattr(lib, f"{row.kernel}_smem_bytes")(top))
        occupancy = getattr(lib, f"{row.kernel}_blocks_per_sm")
        occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
        occupancy.restype = ctypes.c_int
        with torch.cuda.device(0):
            row.runtime_blocks = int(occupancy(ip))
        found = [st for name, st in entries.get(row.kernel, {}).items() if row.entry in name]
        if len(found) != 1:
            row.error = (f"{len(found)} ptxas entries of {row.kernel} match {row.entry}; "
                         "the model's instantiation no longer mirrors the source's dispatch")
            continue
        row.registers = found[0].get("registers")
        row.spill_stores = found[0].get("spill_stores", 0)
        row.spill_loads = found[0].get("spill_loads", 0)
    return rows


def render(rows: list[KernelCost]) -> str:
    """The report as a text table, the card's columns where filled."""
    card = any(r.runtime_blocks is not None for r in rows)
    head = ["kernel", "config", "smem B", "pass", "threads", "blocks/SM model"]
    if card:
        head += ["lib smem B", "blocks/SM runtime", "regs", "spill st/ld B"]
    head.append("ok")
    lines = [" | ".join(head)]
    for r in rows:
        cells = [r.kernel, r.config, str(r.smem_bytes),
                 "-" if r.pass_slots is None else f"{r.pass_slots} (max {r.max_slots}: "
                 f"{r.max_slots_smem_bytes} B)", str(r.threads), str(r.blocks_by_smem)]
        if card:
            cells += [str(r.lib_smem_bytes), str(r.runtime_blocks), str(r.registers),
                      f"{r.spill_stores}/{r.spill_loads}"]
        cells.append("ok" if r.ok else "; ".join(r.problems))
        lines.append(" | ".join(cells))
    return "\n".join(lines)


# --------------------------------------------------------------------------
# the checker
# --------------------------------------------------------------------------


def _launching(tree: ast.Module) -> list[U.FnDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and U.launch_calls(n)]


def _checks_before(fn: U.FnDef, line: int, checkers: set[str]) -> bool:
    """``fn`` calls ``check_smem`` (or a module-local function that does)
    before ``line``."""
    for node in U.own_nodes(fn):
        if (isinstance(node, ast.Call) and node.lineno < line
                and U.dotted_name(node.func).rsplit(".", 1)[-1] in checkers):
            return True
    return False


def _smem_checkers(tree: ast.Module) -> set[str]:
    """``check_smem`` and the module-level functions that call it."""
    out = {"check_smem"}
    for fn in tree.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                isinstance(n, ast.Call) and U.dotted_name(n.func).rsplit(".", 1)[-1]
                == "check_smem" for n in ast.walk(fn)):
            out.add(fn.name)
    return out


@register(
    "smem-over-budget",
    "kernel launcher not tied to the shared-memory budget (no smem_bytes, no "
    "check_smem before the launch, not in smem_cost.KERNEL_MODULES), or a "
    "representative config over 227 KB a block or with no block an SM",
    scope="project",
)
def check_smem_budget(project: Project) -> Iterator[Finding]:
    for src in project.glob("src/repro_torch/kernels/"):
        launchers = _launching(src.tree)
        if not launchers:
            continue
        yield from _tie_findings(src, launchers)
    report = cost_report(project)
    if report is None:                         # pragma: no cover - no torch
        return
    for cost in report:
        if cost.ok:
            continue
        src = project.by_rel[cost.module]
        launchers = _launching(src.tree)
        line = launchers[0].lineno if launchers else 1
        yield Finding(
            "smem-over-budget", src.rel, line, 0,
            f"`{cost.kernel}` under {cost.config}: {'; '.join(cost.problems)}; shrink "
            "page_words or the heads, or redesign the block's shared memory",
            src.anchor(line))


def _tie_findings(src: SourceFile, launchers: list[U.FnDef]) -> Iterator[Finding]:
    line = launchers[0].lineno
    defines = any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n.name == "smem_bytes" for n in src.tree.body)
    if not defines:
        yield Finding(
            "smem-over-budget", src.rel, line, 0,
            "kernel module launches a library kernel but defines no smem_bytes: "
            "the shared-memory model (and its report) cannot size its block",
            src.anchor(line))
    checkers = _smem_checkers(src.tree)
    for fn in launchers:
        first = U.launch_calls(fn)[0].lineno
        if not _checks_before(fn, first, checkers):
            yield Finding(
                "smem-over-budget", src.rel, fn.lineno, fn.col_offset,
                f"`{fn.name}` launches a kernel without calling check_smem first; "
                "a config past 227 KB a block must raise before the launch",
                src.anchor(fn.lineno))
    if src.rel not in KERNEL_MODULES:
        yield Finding(
            "smem-over-budget", src.rel, line, 0,
            "kernel module is not registered in analysis/smem_cost.py "
            "(KERNEL_MODULES): add its representative configs so the "
            "shared-memory report covers it",
            src.anchor(line))
