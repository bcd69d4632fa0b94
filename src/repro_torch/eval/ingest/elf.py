"""ELF core-dump reader — pure-stdlib ``struct`` parsing, no dependencies.

The paper's real inputs are ELF memory dumps of SPEC/PARSEC/Java
processes.  This reader extracts exactly what the codec cares about: the
``PT_LOAD`` program segments (the process's mapped memory contents), each
becoming one :class:`~repro_torch.eval.ingest.container.Segment` with its
virtual address, in address order.  Notes, headers and section tables are
skipped — they are dump bookkeeping, not workload memory.

Both ELF64 and ELF32 images parse, in either byte order (``EI_DATA``
drives the ``struct`` endianness prefix and is recorded on the image so
``word_stream`` can restore logical word values on any host).  ``ET_CORE``
is the expected type, but executables/shared objects are accepted too —
their loadable segments are still real memory images — with the type
recorded in ``meta['elf_type']``.
"""
from __future__ import annotations

import struct
from pathlib import Path

from repro_torch.eval.ingest.container import DumpImage, Segment

ELF_MAGIC = b"\x7fELF"
PT_LOAD = 1
_ET_NAMES = {1: "ET_REL", 2: "ET_EXEC", 3: "ET_DYN", 4: "ET_CORE"}


def is_elf(path: str | Path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == ELF_MAGIC
    except OSError:
        return False


def read_elf_core(
    path: str | Path,
    *,
    name: str | None = None,
    word_bits: int = 32,
    max_bytes: int | None = None,
) -> DumpImage:
    """Parse an ELF image into a :class:`DumpImage` of its PT_LOAD segments.

    ``max_bytes`` truncates the total extracted bytes (whole segments are
    kept until the budget is crossed, then the crossing segment is cut) —
    the streaming chunker samples anyway, so a cap only bounds container
    size, not coverage semantics.  Segments are ``seek``/``read`` straight
    from the program-header offsets, so a multi-GB core with a small cap
    never materialises in memory.
    """
    path = Path(path)
    with open(path, "rb") as f:
        file_size = path.stat().st_size
        ehdr = f.read(64)
        if ehdr[:4] != ELF_MAGIC:
            raise ValueError(f"{path}: not an ELF file (bad magic)")
        ei_class, ei_data = ehdr[4], ehdr[5]
        if ei_class not in (1, 2):
            raise ValueError(f"{path}: bad EI_CLASS {ei_class}")
        if ei_data not in (1, 2):
            raise ValueError(f"{path}: bad EI_DATA {ei_data}")
        is64 = ei_class == 2
        end = "<" if ei_data == 1 else ">"

        try:
            if is64:
                # e_type, e_machine, e_version, e_entry, e_phoff, e_shoff,
                # e_flags, e_ehsize, e_phentsize, e_phnum, ...
                (e_type, _mach, _ver, _entry, e_phoff, _shoff, _flags, _ehsz,
                 e_phentsize, e_phnum) = struct.unpack_from(
                    end + "HHIQQQIHHH", ehdr, 16)
            else:
                (e_type, _mach, _ver, _entry, e_phoff, _shoff, _flags, _ehsz,
                 e_phentsize, e_phnum) = struct.unpack_from(
                    end + "HHIIIIIHHH", ehdr, 16)
        except struct.error:
            raise ValueError(f"{path}: truncated ELF header")

        f.seek(e_phoff)
        phdrs = f.read(e_phentsize * e_phnum)
        if len(phdrs) < e_phentsize * e_phnum:
            raise ValueError(f"{path}: program header table extends past EOF")

        segments: list[Segment] = []
        total = 0
        for i in range(e_phnum):
            off = i * e_phentsize
            if is64:
                p_type, p_flags, p_offset, p_vaddr, _pa, p_filesz, _memsz, \
                    _al = struct.unpack_from(end + "IIQQQQQQ", phdrs, off)
            else:
                p_type, p_offset, p_vaddr, _pa, p_filesz, _memsz, p_flags, \
                    _al = struct.unpack_from(end + "IIIIIIII", phdrs, off)
            if p_type != PT_LOAD or p_filesz == 0:
                continue
            if p_offset + p_filesz > file_size:
                raise ValueError(
                    f"{path}: PT_LOAD[{i}] extends past EOF "
                    f"({p_offset}+{p_filesz} > {file_size})")
            want = p_filesz
            if max_bytes is not None:
                want = min(want, max_bytes - total)
            if want <= 0:
                break
            f.seek(p_offset)
            data = f.read(want)
            perms = "".join(c if p_flags & b else "-"
                            for c, b in (("r", 4), ("w", 2), ("x", 1)))
            segments.append(Segment(
                name=f"load{len(segments)}@0x{p_vaddr:x}",
                data=bytearray(data), vaddr=p_vaddr, note=f"perms={perms}"))
            total += len(data)
            if max_bytes is not None and total >= max_bytes:
                break
    if not segments:
        raise ValueError(f"{path}: no non-empty PT_LOAD segments")

    return DumpImage(
        name=name or path.stem,
        segments=segments,
        word_bits=word_bits,
        endian="little" if ei_data == 1 else "big",
        source=str(path),
        meta={"format": "elf", "elf_class": 64 if is64 else 32,
              "elf_type": _ET_NAMES.get(e_type, str(e_type)),
              "n_load_segments": len(segments)},
    )
