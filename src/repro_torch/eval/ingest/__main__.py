"""``python -m repro_torch.eval.ingest`` — turn memory images into eval families.

  python -m repro_torch.eval.ingest core.1234                  # ELF core dump
  python -m repro_torch.eval.ingest weights.npy acts.npz x.bin # tensor files
  python -m repro_torch.eval.ingest params.pkl --name run42    # pickled pytree
  python -m repro_torch.eval.ingest --capture-pid $$ --allow-proc-capture
  python -m repro_torch.eval.ingest --list
  python -m repro_torch.eval.run --suite dump                  # then evaluate

Each input is parsed (format auto-detected: ELF magic, then suffix),
normalised into the dump container format, and written to ``--dump-dir``
(default ``experiments/dumps``, or ``$REPRO_DUMP_DIR``); the family is
then available to every ``repro_torch.eval.run`` mode as ``dump:<name>`` and in
the ``dump`` suite.  Process capture is opt-in (``--allow-proc-capture``
or ``REPRO_ALLOW_PROC_CAPTURE=1``) and needs ptrace rights.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.eval import ingest


def _describe(image: ingest.DumpImage, path: Path) -> str:
    segs = image.segments
    head = (f"dump:{image.name}  [{image.meta.get('format', '?')}] "
            f"{image.n_bytes} B in {len(segs)} segment(s), "
            f"word_bits={image.word_bits}, {image.endian}-endian -> {path}")
    lines = [head]
    for s in segs[:8]:
        lines.append(f"  {s.name:<32} {s.n_bytes:>10} B  {s.note}")
    if len(segs) > 8:
        lines.append(f"  ... {len(segs) - 8} more segment(s)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval.ingest",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="input images: ELF core (magic-detected), "
                         ".npy/.npz, .pkl/.pickle pytree, or raw binary")
    ap.add_argument("--dump-dir", default=None,
                    help="where containers land and repro_torch.eval.run scans "
                         "(default: $REPRO_DUMP_DIR or experiments/dumps)")
    ap.add_argument("--name", default=None,
                    help="family name override (single input only; "
                         "default: file stem)")
    ap.add_argument("--word-bits", type=int, choices=(16, 32), default=None,
                    help="word framing override (default: ELF/raw 32; "
                         "tensors by dtype — 2-byte dtypes 16, else 32)")
    ap.add_argument("--max-bytes", type=int, default=None,
                    help="cap container payload bytes (ELF/process capture)")
    ap.add_argument("--force", action="store_true",
                    help="overwrite an existing container of the same name")
    ap.add_argument("--list", action="store_true",
                    help="list containers in --dump-dir and exit")
    ap.add_argument("--capture-pid", type=int, default=None,
                    help="snapshot a live process instead of reading files "
                         "(Linux /proc; opt-in, see --allow-proc-capture)")
    ap.add_argument("--allow-proc-capture", action="store_true",
                    help="consent flag for --capture-pid (or set "
                         "REPRO_ALLOW_PROC_CAPTURE=1)")
    args = ap.parse_args(argv)

    dump_dir = Path(args.dump_dir or ingest.default_dump_dir())

    if args.list:
        rows = []
        for p in sorted(dump_dir.glob("*.npz")):
            try:
                m = ingest.load_meta(p)
            except Exception:
                continue
            rows.append(f"dump:{m['name']:<24} {m['n_bytes']:>12} B  "
                        f"wb={m['word_bits']} {m['endian']:<6} "
                        f"{m.get('meta', {}).get('format', '?'):<7} {p}")
        print("\n".join(rows) if rows else f"no dump containers in {dump_dir}")
        return []

    images: list[ingest.DumpImage] = []
    if args.capture_pid is not None:
        images.append(ingest.capture_process(
            args.capture_pid, allow=args.allow_proc_capture,
            name=args.name,
            max_bytes=args.max_bytes or ingest.capture.DEFAULT_MAX_BYTES,
            word_bits=args.word_bits or 32))
    if not images and not args.paths:
        ap.error("no inputs: give image paths, --capture-pid, or --list")
    if args.name and len(args.paths) + len(images) > 1:
        ap.error("--name only applies to a single input")

    for path in args.paths:
        path = Path(path)
        if not path.is_file():
            raise SystemExit(f"error: {path}: no such file")
        try:
            if ingest.is_elf(path):
                images.append(ingest.read_elf_core(
                    path, name=args.name, word_bits=args.word_bits or 32,
                    max_bytes=args.max_bytes))
            else:
                images.append(ingest.read_tensor_file(
                    path, name=args.name, word_bits=args.word_bits))
        except ValueError as e:
            raise SystemExit(f"error: {path}: {e}")

    names = [im.name for im in images]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise SystemExit(f"error: duplicate dump name(s) {dupes} in one "
                         "invocation (same file stem? disambiguate with "
                         "--name, one input at a time)")

    families: list[str] = []
    for image in images:
        out = dump_dir / f"{image.name}.npz"
        if out.exists() and not args.force:
            raise SystemExit(f"error: {out} exists (use --force, or --name "
                             "to register under a different family)")
        image.save(out)
        print(_describe(image, out))
        families.append(f"dump:{image.name}")
    print(f"registered {len(families)} family(ies): {', '.join(families)}\n"
          f"evaluate with: python -m repro_torch.eval.run --suite dump "
          f"--dump-dir {dump_dir}")
    return families


if __name__ == "__main__":
    main()  # error paths raise SystemExit themselves
