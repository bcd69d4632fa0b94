"""Format-invariant checkers.

Port of ``src/repro/analysis/format_checkers.py``.  ``docs/FORMAT.md`` is
normative and :mod:`repro_torch.core.format` is the port's executable copy
of its constants.  Wrapper code (``kernels/``, ``serving/``,
``distributed/``) that re-spells a bit-width mask or a default cap as a
bare integer silently diverges the day the format revs; these checkers
force every such value back to a named constant, hold each kernel op to its
twins (a plain version, a ``kernels/ref.py`` oracle, a CUDA source with the
three C entry points, a build entry), and diff ``docs/FORMAT.md`` §6
against the port's serializer and encoder.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator

from repro_torch.analysis import _ast_util as U
from repro_torch.analysis.base import register
from repro_torch.analysis.finding import Finding
from repro_torch.analysis.project import Project, SourceFile

# --------------------------------------------------------------------------
# format-magic-literal
# --------------------------------------------------------------------------

#: directories where format values must be spelled via repro_torch.core.format
_FORMAT_SCOPED = ("src/repro_torch/kernels/", "src/repro_torch/serving/",
                  "src/repro_torch/distributed/")

#: bare integers that are really format constants
_MASK_LITERALS = {
    0xFFFF: "repro_torch.core.format.WORD16_MASK (or word_mask(bits))",
    1 << 15: "repro_torch.core.format.WORD16_HALF (or half_span(bits))",
}

#: FRConfig constructor kwargs whose defaults have named constants
_FRCONFIG_KW = {
    "page_words": ("DEFAULT_PAGE_WORDS", 2048),
    "num_bases": ("DEFAULT_NUM_BASES", 14),
    "outlier_cap": ("DEFAULT_OUTLIER_CAP", 64),
}


def _in_format_scope(src: SourceFile) -> bool:
    return src.rel.startswith(_FORMAT_SCOPED)


@register(
    "format-magic-literal",
    "bit-width/cap integer literal in kernels|serving|distributed that must "
    "reference a named constant in repro_torch.core.format",
)
def check_format_magic_literal(src: SourceFile) -> Iterator[Finding]:
    if not _in_format_scope(src):
        return
    for node in ast.walk(src.tree):
        # masks / bias spans spelled inline: `val & 0xFFFF`, `+ (1 << 15)`
        if isinstance(node, ast.Constant) and node.value in _MASK_LITERALS \
                and not isinstance(node.value, bool):
            yield Finding(
                "format-magic-literal", src.rel, node.lineno, node.col_offset,
                f"magic literal {node.value:#x} re-spells a format constant; "
                f"use {_MASK_LITERALS[node.value]}",
                src.anchor(node.lineno))
        elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift)
              and isinstance(node.left, ast.Constant) and node.left.value == 1
              and isinstance(node.right, ast.Constant)
              and node.right.value in (7, 15, 31)):
            yield Finding(
                "format-magic-literal", src.rel, node.lineno, node.col_offset,
                f"magic span (1 << {node.right.value}) re-spells a format "
                "bias; use repro_torch.core.format.half_span(bits)",
                src.anchor(node.lineno))
        # FRConfig(...) constructed with bare default literals
        elif (isinstance(node, ast.Call)
              and U.dotted_name(node.func).rsplit(".", 1)[-1] == "FRConfig"):
            for kw in node.keywords:
                spec = _FRCONFIG_KW.get(kw.arg or "")
                if (spec is not None and isinstance(kw.value, ast.Constant)
                        and kw.value.value == spec[1]):
                    yield Finding(
                        "format-magic-literal", src.rel,
                        kw.value.lineno, kw.value.col_offset,
                        f"FRConfig({kw.arg}={spec[1]}) re-spells the format "
                        f"default; use repro_torch.core.format.{spec[0]}",
                        src.anchor(kw.value.lineno))


# --------------------------------------------------------------------------
# backend-parity
# --------------------------------------------------------------------------

_KERNELS_DIR = "src/repro_torch/kernels/"
_ORACLE_MOD = _KERNELS_DIR + "ref.py"
_BUILD_MOD = _KERNELS_DIR + "_build.py"
_WRAPPER_PREFIX = _KERNELS_DIR + "gbdi_"
_CSRC = _KERNELS_DIR + "csrc/"
#: the C entry points every kernel library exports
_C_ENTRIES = ("launch", "smem_bytes", "blocks_per_sm")
_EXTERN_C = re.compile(r'^\s*extern\s+"C"[^(]*?\b(\w+)\s*\(', re.MULTILINE)


def _op_stem(name: str) -> str | None:
    """Canonical op of a public wrapper function, or None for helpers and
    the plain twins themselves."""
    low = name.lower()
    if low.endswith("_plain") or "smem" in low or low.endswith("_bytes") \
            or low.startswith("check_"):
        return None
    if "attention" in low:
        return "attention"
    if "encode" in low:
        return "encode"
    if "decode" in low:
        return "decode"
    return None


def _public_defs(src: SourceFile) -> Iterator[ast.FunctionDef]:
    for node in src.tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            yield node


def _built_kernels(project: Project) -> set[str] | None:
    """Names in ``_build.KERNELS`` (from the project's parse, else the file
    under the root); None when neither exists."""
    src = project.by_rel.get(_BUILD_MOD)
    if src is not None:
        tree = src.tree
    else:
        path = project.root / _BUILD_MOD
        if not path.is_file():
            return None
        tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "KERNELS" for t in node.targets)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return {e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return set()


def c_entries(path: Path) -> set[str]:
    """Function names a CUDA source exports with ``extern "C"``."""
    if not path.is_file():
        return set()
    return set(_EXTERN_C.findall(path.read_text(encoding="utf-8")))


@register(
    "backend-parity",
    "every public encode/decode/attention op in kernels/gbdi_*.py needs a *_plain "
    "twin, a kernels/ref.py twin, a csrc/<module>.cu exporting <module>_launch/"
    "_smem_bytes/_blocks_per_sm, and an entry in _build.KERNELS",
    scope="project",
)
def check_backend_parity(project: Project) -> Iterator[Finding]:
    oracle = project.by_rel.get(_ORACLE_MOD)
    oracle_stems = {_op_stem(f.name) for f in _public_defs(oracle)} if oracle else set()
    built = _built_kernels(project)
    for src in project.files:
        if not (src.rel.startswith(_WRAPPER_PREFIX) and src.rel.endswith(".py")):
            continue
        module = Path(src.rel).stem
        defs = {f.name for f in _public_defs(src)}
        cu = project.root / _CSRC / f"{module}.cu"
        exported = c_entries(cu)
        for fn in _public_defs(src):
            stem = _op_stem(fn.name)
            if stem is None:
                continue
            missing = []
            if f"{fn.name}_plain" not in defs:
                missing.append(f"a `{fn.name}_plain` twin")
            if oracle is not None and stem not in oracle_stems:
                missing.append(f"a kernels/ref.py `{stem}` oracle")
            if not cu.is_file():
                missing.append(f"csrc/{module}.cu")
            else:
                lost = [f"{module}_{e}" for e in _C_ENTRIES if f"{module}_{e}" not in exported]
                if lost:
                    missing.append(f"extern \"C\" {', '.join(lost)} in csrc/{module}.cu")
            if built is not None and module not in built:
                missing.append(f"`{module}` in _build.KERNELS")
            if missing:
                yield Finding(
                    "backend-parity", src.rel, fn.lineno, fn.col_offset,
                    f"op `{fn.name}` ({stem}) lacks {'; '.join(missing)}; every "
                    "kernel op is held to its plain version and the oracle, and "
                    "built, sized and launched through the same C entry points",
                    src.anchor(fn.lineno))


# --------------------------------------------------------------------------
# format-schema-drift
# --------------------------------------------------------------------------

_FORMAT_DOC = "docs/FORMAT.md"
_SERIALIZER_MOD = "src/repro_torch/core/format_doc.py"
_ENCODER_MOD = "src/repro_torch/kernels/gbdi_encode.py"

#: dtype tokens -> byte width ("word" = word_bits/8, config-dependent)
_DTYPE_BYTES = {"uint8": 1, "uint16": 2, "uint32": 4, "int32": 4,
                "<u1": 1, "<u2": 2, "<u4": 4, "<i4": 4}

_LAYOUT_LINE = re.compile(r"^(\w+)(?:\s+\w+)?\s+:\s+(.*)$")


def _doc_section6(text: str) -> tuple[int, list[str]] | None:
    """(1-based start line, lines) of FORMAT.md section 6, or None."""
    lines = text.splitlines()
    start = end = None
    for i, line in enumerate(lines):
        if line.startswith("## 6."):
            start = i
        elif start is not None and line.startswith("## ") and i > start:
            end = i
            break
    if start is None:
        return None
    return start + 1, lines[start:end or len(lines)]


def _doc_table_fields(sec: list[str], base: int) -> list[tuple[str, int]]:
    """Backticked field names from the section-6 table -> (name, lineno)."""
    out: list[tuple[str, int]] = []
    for off, line in enumerate(sec):
        s = line.strip()
        if not (s.startswith("|") and "`" in s):
            continue
        first_col = s.split("|")[1]
        for name in re.findall(r"`(\w+)`", first_col):
            out.append((name, base + off))
    return out


def _doc_layout(sec: list[str], base: int) -> list[tuple[str, object, int]]:
    """(field, byte width | 'word', lineno) rows of the serialized-layout
    fenced block, continuation lines folded into their field row."""
    rows: list[tuple[str, object, int]] = []
    in_block = False
    for off, line in enumerate(sec):
        if line.strip().startswith("```"):
            if in_block:
                break
            in_block = True
            continue
        if not in_block:
            continue
        m = _LAYOUT_LINE.match(line)
        if m is None:
            continue                           # continuation line
        name, rest = m.group(1), m.group(2)
        width: object = next(
            (w for tok, w in _DTYPE_BYTES.items() if tok in rest), None)
        if "word_bits/8" in rest or "word-sized" in rest:
            width = "word"
        rows.append((name, width, base + off))
    return rows


def _blob_key_of(node: ast.expr, locals_map: dict[str, str]) -> str | None:
    """The blob dict key a serializer expression reads, through locals."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Subscript)
                and isinstance(sub.value, ast.Name) and sub.value.id == "blob"
                and isinstance(sub.slice, ast.Constant)):
            return str(sub.slice.value)
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in locals_map:
            return locals_map[sub.id]
    return None


def _astype_width(node: ast.expr) -> object:
    """Byte width from the outermost ``.astype(...)`` of a serializer
    expression's method chain: the port's serializer reads through
    ``_np(...)`` and chains casts (``.astype(np.int32).astype("<i4")``), and
    the last cast is the stored width."""
    cur: ast.AST = node
    while True:
        while isinstance(cur, ast.BinOp):       # `(x & mask).astype(...)` is inside
            cur = cur.left
        if not (isinstance(cur, ast.Call) and isinstance(cur.func, ast.Attribute)):
            return None
        if cur.func.attr == "astype" and cur.args:
            arg = cur.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                return _DTYPE_BYTES.get(arg.value)
            if isinstance(arg, ast.Name) and arg.id == "val_dt":
                return "word"
            return None
        cur = cur.func.value


def _serializer_layout(src: SourceFile) -> list[tuple[str, object]] | None:
    """(blob key, byte width | 'word') sequence of ``serialize_page``."""
    fn = next((n for n in src.tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "serialize_page"), None)
    if fn is None:
        return None
    locals_map: dict[str, str] = {}
    header_key: str | None = None
    join_list: ast.List | None = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            tgt = node.targets[0].id
            key = _blob_key_of(node.value, locals_map)
            if key is not None:
                locals_map[tgt] = key
            for sub in ast.walk(node.value):
                if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                        and sub.func.id == "bytes"):
                    header_key = _blob_key_of(node.value, locals_map) or "profile"
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join" and node.args \
                and isinstance(node.args[0], (ast.List, ast.Tuple)):
            join_list = node.args[0]  # type: ignore[assignment]
    if join_list is None:
        return None
    rows: list[tuple[str, object]] = []
    if header_key is not None:
        rows.append((header_key, 1))
    for el in join_list.elts:
        key = _blob_key_of(el, locals_map)
        rows.append((key or "?", _astype_width(el)))
    return rows


def _encoder_blob_keys(src: SourceFile) -> set[str]:
    """Keys of the blob dict the port's encoder wrapper returns."""
    keys: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name) and tgt.id == "blob"
                        and isinstance(node.value, ast.Dict)):
                    keys |= {k.value for k in node.value.keys
                             if isinstance(k, ast.Constant)}
                elif (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "blob"
                        and isinstance(tgt.slice, ast.Constant)):
                    keys.add(str(tgt.slice.value))
    return keys


@register(
    "format-schema-drift",
    "docs/FORMAT.md section-6 field table / serialized layout diverges from "
    "format_doc.serialize_page or the encoder blob fields",
    scope="project",
)
def check_format_schema_drift(project: Project) -> Iterator[Finding]:
    ser_src = project.by_rel.get(_SERIALIZER_MOD)
    doc_path = project.root / _FORMAT_DOC
    if ser_src is None or not doc_path.is_file():
        return                                 # fixture projects: no contract
    text = doc_path.read_text(encoding="utf-8")
    doc_lines = text.splitlines()

    def anchor(lineno: int) -> str:
        return doc_lines[lineno - 1].strip() if lineno <= len(doc_lines) else ""

    sec = _doc_section6(text)
    if sec is None:
        yield Finding(
            "format-schema-drift", _FORMAT_DOC, 1, 0,
            "docs/FORMAT.md has no '## 6.' blob-layout section to check "
            "against format_doc.serialize_page", anchor(1))
        return
    base, sec_lines = sec

    code_layout = _serializer_layout(ser_src)
    if code_layout is None:
        yield Finding(
            "format-schema-drift", ser_src.rel, 1, 0,
            "could not extract the serialized-page layout from "
            "format_doc.serialize_page (expected a b''.join([...]) of "
            "blob-field .astype(...) chunks)", ser_src.anchor(1))
        return

    doc_layout = _doc_layout(sec_lines, base)
    doc_seq = [(n, w) for n, w, _ in doc_layout]
    if doc_seq != code_layout:
        line = doc_layout[0][2] if doc_layout else base
        yield Finding(
            "format-schema-drift", _FORMAT_DOC, line, 0,
            "serialized-page layout in docs/FORMAT.md section 6 "
            f"({doc_seq}) diverges from format_doc.serialize_page "
            f"({code_layout}); regenerate the doc or fix the serializer",
            anchor(line))

    table = _doc_table_fields(sec_lines, base)
    enc_src = project.by_rel.get(_ENCODER_MOD)
    if enc_src is not None and table:
        doc_fields = {n for n, _ in table}
        enc_fields = _encoder_blob_keys(enc_src)
        if enc_fields and doc_fields != enc_fields:
            missing = sorted(enc_fields - doc_fields)
            extra = sorted(doc_fields - enc_fields)
            line = table[0][1]
            parts = []
            if missing:
                parts.append(f"encoder blob fields missing from the table: {missing}")
            if extra:
                parts.append(f"table rows with no encoder blob field: {extra}")
            yield Finding(
                "format-schema-drift", _FORMAT_DOC, line, 0,
                "blob field table in docs/FORMAT.md section 6 diverges from "
                f"the encoder blob dict ({'; '.join(parts)})", anchor(line))
