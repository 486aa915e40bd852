"""glz command-line interface, on the card.

glz_tpu's command line (python -m glz_tpu.cli) with the same commands,
options, output files and printed lines; only the timings differ.  It covers
the reference tool's utet modes (unit_tests/test.cc:286-317): 1/2
normal-tree compress/decompress, 3/4 canonical byte, 5 fast decode, 6 table
decode; plus the .glz codec, HuffWord and the .glzb archive.

Usage:
    python -m glz_tpu_torch.cli compress   <in> [out] [--model canonical_byte|huffword|normal_tree]
                                            [--backend host|device] [--layout bitstream|lockstep]
                                            [--preset default|ratio|throughput]
                                            [--stream-symbols N] [--group-rows 8|16|32|64]
                                            [--checksum] [--compat crs|crs2|crs3]
    python -m glz_tpu_torch.cli decompress <in> [out] [--backend host|device]
                                            [--decoder table|fast|bitwalk|device]
    python -m glz_tpu_torch.cli archive   <out.glzb> <in>... [compress options;
                                            --model canonical_byte|huffword]
    python -m glz_tpu_torch.cli unarchive <in.glzb> <out>... [--backend ...]
    python -m glz_tpu_torch.cli utet <in> <mode 1-6>     # reference CLI emulation
    python -m glz_tpu_torch.cli info <in> [--stats] [--original FILE] [--dot FILE]

The codec runs on the CUDA card.  GLZ_PLATFORM=cpu runs it on the CPU
instead, through the kernels' plain PyTorch versions; without that setting
and without a card, every command fails at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import sys
import time

from glz_tpu_torch import config as cfg

PRESETS = {"default": cfg.DEFAULT, "ratio": cfg.RATIO, "throughput": cfg.THROUGHPUT}
ARCHIVE_MODELS = ["canonical_byte", "huffword"]  # the shared-codebook modes


def _device() -> str | None:
    """The device the codec runs on: None (the card) unless GLZ_PLATFORM=cpu."""
    return "cpu" if os.environ.get("GLZ_PLATFORM") == "cpu" else None


def _prepare_device_backend(device) -> None:
    """Build (on first use) and load the host library and, on the card, the
    kernel library, so that neither build lands inside a timed call; say so
    on stderr when one compiles."""
    from glz_tpu_torch.utils import native

    if not native.library_path().exists():
        print("note: compiling the host library (first use)", file=sys.stderr, flush=True)
    native.library()
    if device is None:
        from glz_tpu_torch.ops import _kernels

        if not _kernels.library_path().exists():
            print("note: compiling the CUDA kernels (first use; under a minute)",
                  file=sys.stderr, flush=True)
        _kernels.library()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def _make_conf(args) -> cfg.GlzConfig:
    conf = PRESETS[args.preset]
    over = {}
    if args.layout:
        over["layout"] = args.layout
        if args.layout == cfg.LAYOUT_LOCKSTEP and conf.layout != cfg.LAYOUT_LOCKSTEP \
                and not args.stream_symbols:
            over["stream_symbols"] = cfg.THROUGHPUT.stream_symbols
    if args.stream_symbols:
        over["stream_symbols"] = args.stream_symbols
    if getattr(args, "group_rows", 0):
        over["group_rows"] = args.group_rows
    if args.checksum:
        over["checksum"] = True
    return dataclasses.replace(conf, **over) if over else conf


def cmd_compress(args) -> int:
    from glz_tpu_torch import compress
    from glz_tpu_torch.compat import glzip_format
    from glz_tpu_torch.models import by_name

    data = _read(args.infile)
    if not args.compat:
        _prepare_device_backend(args.device)
    t0 = time.perf_counter()
    if args.compat == "crs2":
        blob = glzip_format.write_crs2(data)
        out = args.outfile or args.infile + ".crs2"
    elif args.compat == "crs3":
        blob = glzip_format.write_crs3(data)
        out = args.outfile or args.infile + ".crs3"
    elif args.compat == "crs":
        blob = glzip_format.write_crs(data)
        out = args.outfile or args.infile + ".crs"
    else:
        blob = compress(data, mode=by_name(args.model), backend=args.backend,
                        conf=_make_conf(args), device=args.device)
        out = args.outfile or args.infile + ".glz"
    dt = time.perf_counter() - t0
    _write(out, blob)
    ratio = len(blob) / max(1, len(data))
    print(f"{args.infile} -> {out}: {len(data)} -> {len(blob)} bytes "
          f"(ratio {ratio:.4f}) in {dt*1e3:.1f} ms "
          f"[{len(data)/max(dt,1e-9)/1e6:.1f} MB/s]")
    return 0


def cmd_decompress(args) -> int:
    from glz_tpu_torch import decompress
    from glz_tpu_torch.compat import glzip_format
    from glz_tpu_torch.core import container

    blob = _read(args.infile)
    glz = container.is_glz(blob) or not args.infile.endswith((".crs3", ".crs2", ".crs"))
    if glz:
        _prepare_device_backend(args.device)
    t0 = time.perf_counter()
    if glz:
        data = decompress(blob, backend=args.backend, variant=args.decoder, device=args.device)
    elif args.infile.endswith(".crs3"):
        data = glzip_format.read_crs3(blob)
    elif args.infile.endswith(".crs2"):
        data = glzip_format.read_crs2(blob)
    else:
        data = glzip_format.read_crs(blob)
    dt = time.perf_counter() - t0
    out = args.outfile or args.infile + ".de"   # reference default (encoder.h:229-231)
    _write(out, data)
    print(f"{args.infile} -> {out}: {len(blob)} -> {len(data)} bytes "
          f"in {dt*1e3:.1f} ms [{len(data)/max(dt,1e-9)/1e6:.1f} MB/s]")
    return 0


def cmd_utet(args) -> int:
    """Reference utet CLI emulation (test.cc:291-317)."""
    from glz_tpu_torch.compat import glzip_format

    mode = int(args.mode)
    data = _read(args.infile)
    if mode == 1:
        _write(args.infile + ".crs", glzip_format.write_crs(data))
    elif mode == 2:
        _write(args.infile + ".de", glzip_format.read_crs(data))
    elif mode == 3:
        _write(args.infile + ".crs2", glzip_format.write_crs2(data))
    elif mode in (4, 5, 6):  # three decoder strategies, same result
        _write(args.infile + ".de", glzip_format.read_crs2(data))
    else:
        print("mode must be 1-6", file=sys.stderr)
        return 2
    return 0


def _payload_bits(f) -> int:
    from glz_tpu_torch.core import container

    if f.layout == container.LAYOUT_LOCKSTEP:
        return 32 * int(f.stream_bits.sum())
    return int(f.stream_bits.sum())


def stats_report(f, freqs=None) -> str:
    """Codebook statistics for a byte-mode container — the reference's
    per-symbol freq/length/code report with average code length and
    predicted compression ratio (canonical_huff_encoder.cc:144-186,
    normal_huff_encoder.h:204-271).  freqs (a 256-bin histogram of the
    original data) enables the frequency and predicted-ratio columns."""
    from glz_tpu_torch.core import container
    from glz_tpu_torch.core.codebook import canonical_codebook

    lengths = container.decode_byte_codebook(f.codebook_blob)
    cb = canonical_codebook(lengths)
    lines = ["symbol  char  freq        length  code"]
    for s in range(256):
        if lengths[s] == 0 and (freqs is None or freqs[s] == 0):
            continue
        ch = chr(s) if 32 <= s < 127 else "."
        fr = f"{int(freqs[s]):<10d}" if freqs is not None else "-         "
        code = format(int(cb.codewords[s]), f"0{int(lengths[s])}b") if lengths[s] else "-"
        lines.append(f"{s:<7d} {ch}     {fr}  {int(lengths[s]):<7d} {code}")
    payload_bits = _payload_bits(f)
    if f.n_symbols:
        actual = payload_bits / (8 * f.n_symbols)
        lines.append(f"actual payload ratio: {actual:.4f} "
                     f"({payload_bits} bits / {f.n_symbols} symbols)")
    if freqs is not None and freqs.sum() > 0:
        avg = float((freqs * lengths).sum() / freqs.sum())
        lines.append(f"average code length: {avg:.4f} bits/symbol")
        lines.append(f"predicted ratio: {avg / 8:.4f}")
    return "\n".join(lines)


def stats_report_huffword(f, original: bytes | None = None, top: int = 20) -> str:
    """Per-dictionary token/freq/length/code tables for a huffword
    container — parity with the reference's dual-dict stats report
    (canonical_huffword.h:254-294).  With the original file, adds the
    frequency column and the predicted (avg-code-length) compression ratio
    next to the actual payload ratio."""
    import numpy as np

    from glz_tpu_torch.core.codebook import canonical_codebook
    from glz_tpu_torch.models.huffword import decode_dict_blob
    from glz_tpu_torch.utils import tokenizer as tok

    mv = memoryview(f.codebook_blob)
    word_first = bool(mv[0])
    wl, woff, wblob, off = decode_dict_blob(mv, 1)
    nl, noff, nblob, off = decode_dict_blob(mv, off)

    counts = [None, None]
    lines = [f"word_first={word_first}"]
    if original is not None:
        # build_vocabs assigns (length, content)-rank ids — the same order
        # the container stores, so counts align with the stored tables
        _, _, wf, wv, nv, _ = tok.build_vocabs(original)
        if wv.n == wl.size and nv.n == nl.size:
            counts = [wv.counts, nv.counts]
        else:
            lines.append(
                f"warning: --original tokenizes to {wv.n}+{nv.n} vocab "
                f"entries but this container stores {wl.size}+{nl.size} — "
                "wrong file?  frequency/predicted-ratio columns omitted")
    pred_bits = 0
    for name, lengths, offs, blob, freq in (
            ("word", wl, woff, wblob, counts[0]),
            ("nonword", nl, noff, nblob, counts[1])):
        n = lengths.size
        lo = int(lengths.min()) if n else 0
        lines.append(f"-- {name} dictionary: {n} tokens, "
                     f"code lengths [{lo},{int(lengths.max(initial=0))}]")
        if n == 0:
            continue
        cb = canonical_codebook(lengths)
        if freq is not None:
            tot = int(freq.sum())
            avg = float((freq * lengths).sum()) / max(tot, 1)
            pred_bits += int((freq * lengths).sum())
            lines.append(f"   {tot} occurrences, avg code length {avg:.4f} bits")
            order = np.argsort(-freq, kind="stable")[:top]
        else:
            order = np.argsort(lengths, kind="stable")[:top]
        lines.append("token                    freq        length  code")
        for i in order:
            t = bytes(blob[int(offs[i]) : int(offs[i + 1])])
            disp = repr(t)[1:]
            if len(disp) > 22:
                disp = disp[:19] + "..."
            fr = f"{int(freq[i]):<10d}" if freq is not None else "-         "
            code = format(int(cb.codewords[i]), f"0{int(lengths[i])}b")
            lines.append(f"{disp:<24} {fr}  {int(lengths[i]):<7d} {code}")
    bits = _payload_bits(f)
    if f.n_symbols:
        lines.append(f"actual payload: {bits} bits / {f.n_symbols} tokens "
                     f"({bits / f.n_symbols:.2f} bits/token)")
    if original is not None and len(original):
        lines.append(f"actual ratio: {bits / (8 * len(original)):.4f}")
        if pred_bits:
            lines.append(f"predicted ratio: {pred_bits / (8 * len(original)):.4f}")
    return "\n".join(lines)


def stats_report_tree(f, freqs=None) -> str:
    """Normal-tree codec stats: per-symbol freq/length/code from the .crs
    payload's serialized tree (reference do_print_encode,
    normal_huff_encoder.h:204-271)."""
    from glz_tpu_torch.compat import glzip_format

    table = glzip_format.crs_code_table(f.payload)
    lines = ["symbol  char  freq        length  code"]
    for s in sorted(table):
        ch = chr(s) if 32 <= s < 127 else "."
        fr = f"{int(freqs[s]):<10d}" if freqs is not None else "-         "
        lines.append(f"{s:<7d} {ch}     {fr}  {len(table[s]):<7d} {table[s]}")
    if freqs is not None and freqs.sum() > 0:
        avg = float(sum(int(freqs[s]) * len(c) for s, c in table.items())) / float(freqs.sum())
        lines.append(f"average code length: {avg:.4f} bits/symbol")
        lines.append(f"predicted ratio: {avg / 8:.4f}")
    return "\n".join(lines)


def cmd_archive(args) -> int:
    """Shared-codebook multi-file archive (.glzb): one codebook header for
    the corpus (core/api.compress_archive) — the reference's one-encoder-
    many-files accumulation (compressor.h:53-55) as a CLI surface."""
    from glz_tpu_torch import compress_archive
    from glz_tpu_torch.models import by_name

    datas = [_read(f) for f in args.infiles]
    conf = _make_conf(args)
    _prepare_device_backend(args.device)
    t0 = time.perf_counter()
    blob = compress_archive(datas, mode=by_name(args.model), backend=args.backend, conf=conf,
                            device=args.device)
    dt = time.perf_counter() - t0
    _write(args.outfile, blob)
    total = sum(len(d) for d in datas)
    print(f"{len(datas)} files -> {args.outfile}: {total} -> {len(blob)} "
          f"bytes (ratio {len(blob)/max(1, total):.4f}) in {dt*1e3:.1f} ms")
    return 0


def cmd_unarchive(args) -> int:
    from glz_tpu_torch import decompress_archive
    from glz_tpu_torch.core.api import archive_entries

    blob = _read(args.infile)
    n_files = len(archive_entries(blob)[2])  # read from the headers, before any decode
    if len(args.outfiles) != n_files:
        print(f"archive holds {n_files} files but {len(args.outfiles)} "
              f"output names given", file=sys.stderr)
        return 2
    _prepare_device_backend(args.device)
    t0 = time.perf_counter()
    datas = decompress_archive(blob, backend=args.backend, device=args.device)
    dt = time.perf_counter() - t0
    for out, d in zip(args.outfiles, datas):
        _write(out, d)
    total = sum(len(d) for d in datas)
    print(f"{args.infile} -> {len(datas)} files, {total} bytes "
          f"in {dt*1e3:.1f} ms")
    return 0


def cmd_info(args) -> int:
    from glz_tpu_torch.core import container
    from glz_tpu_torch.core.api import ARCHIVE_MAGIC, archive_entries

    blob = _read(args.infile)
    layouts = {0: "bitstream", 2: "lockstep"}
    modes = {0: "canonical_byte", 1: "huffword", 2: "normal_tree"}
    if blob[:4] == ARCHIVE_MAGIC:
        # every offset checked against the archive's size (archive_entries)
        mode, shared, parts = archive_entries(blob)
        entries = []
        for k, (prefix, body) in enumerate(parts):
            if len(body) < container.HEADER_SIZE:
                raise ValueError(f"corrupt .glzb archive: entry {k} is shorter than a "
                                 "container header")
            (_, _, _, flags, _, n_symbols, _, _, _, _) = \
                struct.unpack_from(container.HEADER_FMT, body, 0)
            entries.append((n_symbols, len(body) + len(prefix), flags & 0x0F))
        print(f"archive mode={modes.get(mode, mode)} files={len(entries)} "
              f"shared_codebook={len(shared)}B "
              f"layout={layouts.get(entries[0][2], entries[0][2]) if entries else '-'}")
        for k, (n_symbols, size, _l) in enumerate(entries):
            print(f"  file {k}: symbols={n_symbols} entry={size}B")
        return 0
    f = container.read_container(blob)
    print(f"mode={modes.get(f.mode, f.mode)} layout={layouts.get(f.layout, f.layout)} "
          f"symbols={f.n_symbols} streams={f.n_streams} "
          f"stream_symbols={f.stream_symbols} codebook={len(f.codebook_blob)}B "
          f"payload={len(f.payload)}B"
          + (f" checksum={f.checksum:#010x}" if f.checksum is not None else ""))
    if args.dot:
        # Graphviz tree rendering — the reference's DEBUG2 visualizer
        # (huff_tree.cc:12-136) as dependency-free DOT text
        if f.mode != cfg.MODE_NORMAL_TREE:
            print("--dot: tree rendering applies to normal_tree containers "
                  "only (canonical codecs have no explicit tree)",
                  file=sys.stderr)
            return 2
        from glz_tpu_torch.compat import glzip_format
        with open(args.dot, "w") as fh:
            fh.write(glzip_format.crs_tree_dot(f.payload) + "\n")
        print(f"Huffman tree written to {args.dot} (render: dot -Tpng)")
    if args.stats:
        original = _read(args.original) if args.original else None
        if f.mode == cfg.MODE_HUFFWORD:
            print(stats_report_huffword(f, original))
            return 0
        freqs = None
        if original is not None:
            from glz_tpu_torch.core.codebook import histogram_bytes
            freqs = histogram_bytes(original)
        if f.mode == cfg.MODE_NORMAL_TREE:
            print(stats_report_tree(f, freqs))
            return 0
        print(stats_report(f, freqs))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="glz")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress")
    c.add_argument("infile")
    c.add_argument("outfile", nargs="?")
    c.add_argument("--model", default="canonical_byte")
    c.add_argument("--backend", default="host", choices=["host", "device"])
    c.add_argument("--layout", default=None, choices=["bitstream", "lockstep"])
    c.add_argument("--preset", default="default", choices=sorted(PRESETS))
    c.add_argument("--stream-symbols", type=int, default=0)
    c.add_argument("--group-rows", type=int, default=0,
                   help="lockstep group geometry (8/16/32/64 rows of 128 "
                        "streams; default from preset)")
    c.add_argument("--checksum", action="store_true")
    c.add_argument("--compat", default=None, choices=["crs", "crs2", "crs3"])
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress")
    d.add_argument("infile")
    d.add_argument("outfile", nargs="?")
    d.add_argument("--backend", default="host", choices=["host", "device"])
    d.add_argument("--decoder", default="table",
                   choices=["table", "fast", "bitwalk", "device"],
                   help="decoder strategy of a bitstream container, each a kernel on the "
                        "card (the CPU under GLZ_PLATFORM=cpu): table (a table of the "
                        "code's first bits), fast (a 32-bit window scanned up from the "
                        "shortest code), bitwalk (one bit at a time), device (the table); "
                        "byte mode takes fast and bitwalk only with --backend host, as "
                        "glz_tpu does")
    d.set_defaults(fn=cmd_decompress)

    a = sub.add_parser("archive")
    a.add_argument("outfile")
    a.add_argument("infiles", nargs="+")
    a.add_argument("--model", default="canonical_byte", choices=ARCHIVE_MODELS)
    a.add_argument("--backend", default="host", choices=["host", "device"])
    a.add_argument("--layout", default=None, choices=["bitstream", "lockstep"])
    a.add_argument("--preset", default="default", choices=sorted(PRESETS))
    a.add_argument("--stream-symbols", type=int, default=0)
    a.add_argument("--group-rows", type=int, default=0)
    a.add_argument("--checksum", action="store_true")
    a.set_defaults(fn=cmd_archive)

    ua = sub.add_parser("unarchive")
    ua.add_argument("infile")
    ua.add_argument("outfiles", nargs="+")
    ua.add_argument("--backend", default="host", choices=["host", "device"])
    ua.set_defaults(fn=cmd_unarchive)

    u = sub.add_parser("utet")
    u.add_argument("infile")
    u.add_argument("mode")
    u.set_defaults(fn=cmd_utet)

    i = sub.add_parser("info")
    i.add_argument("infile")
    i.add_argument("--stats", action="store_true")
    i.add_argument("--original", default=None,
                   help="original file for frequency/predicted-ratio columns")
    i.add_argument("--dot", default=None,
                   help="write the normal-tree codec's Huffman tree as "
                        "Graphviz DOT to this path")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    args.device = _device()
    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print("glz: no CUDA device is available (set GLZ_PLATFORM=cpu to run on the CPU)",
                  file=sys.stderr)
            return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
