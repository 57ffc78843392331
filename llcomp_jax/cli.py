"""Command-line interface.

Covers both reference CLIs (`llcompc.cpp`, `llcompd.cpp`) plus the sliced
device-parallel mode and a stream inspector:

    python -m llcomp_jax.cli compress   <image> [-o OUT] [--slices N|auto]
                                        [--tile-w auto|0|PX]
    python -m llcomp_jax.cli decompress <file.llcomp|.llct> [-o OUT]
    python -m llcomp_jax.cli info       <file.llcomp|.llct>

Like the reference, ``compress`` writes ``<input>.llcomp`` by default (or
``<input>.llct`` in sliced mode) and ``decompress`` writes ``<input>.png``.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

from . import container
from .core.config import EXT, EXT_SLICED


def _cmd_compress(args) -> int:
    from . import api
    from .io import load_image

    img = load_image(args.input)
    slices = args.slices
    if slices not in (None, "auto"):
        slices = int(slices)
    tile_w = args.tile_w
    if tile_w is not None and tile_w != "auto":
        tile_w = int(tile_w)
    elif tile_w == "auto":
        tile_w = None  # api default: pick_tiling decides
    t0 = time.perf_counter()
    blob = api.compress(
        img, slices=slices, backend=args.backend, revision=args.revision,
        tile_w=tile_w,
    )
    dt = time.perf_counter() - t0
    out = pathlib.Path(
        args.output
        if args.output
        else str(args.input) + (EXT_SLICED if container.is_sliced(blob) else EXT)
    )
    out.write_bytes(blob)
    h, w, c = img.shape
    mp = h * w / 1e6
    print(
        f"{args.input}: {img.nbytes} -> {len(blob)} bytes "
        f"({img.nbytes / len(blob):.2f}x, {8 * len(blob) / (h * w):.3f} bpp, "
        f"{mp / dt:.2f} MP/s) -> {out}"
    )
    return 0


def _cmd_decompress(args) -> int:
    from . import api
    from .io import save_image

    data = pathlib.Path(args.input).read_bytes()
    t0 = time.perf_counter()
    img = api.decompress(data, backend=args.backend)
    dt = time.perf_counter() - t0
    out = pathlib.Path(args.output if args.output else str(args.input) + ".png")
    save_image(out, img)
    h, w, c = img.shape
    print(f"{args.input}: {w}x{h}x{c} ({h * w / 1e6 / dt:.2f} MP/s) -> {out}")
    return 0


def _cmd_info(args) -> int:
    data = pathlib.Path(args.input).read_bytes()
    if container.is_sliced(data):
        (streams, w, h, c, slice_h, flags, seed,
         tile_w) = container.unpack_sliced(data)
        mode = ""
        if flags & container.FLAG_PRIMED:
            mode += " primed"
        if flags & container.FLAG_SEEDED:
            mode += f" seeded({len(seed)}B)"
        if flags & container.FLAG_CRC:
            mode += " crc"
        if flags & container.FLAG_TILED:
            mode += f" tiled({tile_w}px)"
        print(f"sliced container v{container.CONTAINER_VERSION} (rev 2{mode})")
        tiles = -(-w // tile_w) if tile_w else 1
        geom = (f"{len(streams)} slices of {slice_h} rows"
                + (f" x {tiles} column tiles of {tile_w} px" if tile_w
                   else ""))
        print(f"  {w}x{h}x{c}, {geom}")
        print(f"  payload {sum(len(s) for s in streams)} bytes, "
              f"{8 * len(data) / (w * h):.3f} bpp")
        lens = [len(s) for s in streams]
        print(f"  slice bytes: min {min(lens)}, max {max(lens)}")
        bad = container.verify_slices(data)
        if bad:
            print(f"  CORRUPT slices (crc mismatch): {bad}")
        elif bad == []:
            print("  integrity: all slice crcs OK")
    elif data[:1] == b"\x77":
        c, w, h = data[1], data[2] | (data[3] << 8), data[4] | (data[5] << 8)
        print("single stream (legacy revision 0, llcomp.js format)")
        print(f"  {w}x{h}x{c}, payload {len(data) - 6} bytes, "
              f"{8 * len(data) / (w * h):.3f} bpp")
    else:
        payload, w, h, c = container.unpack_single(data)
        print("single stream (rev 2, reference-compatible)")
        print(f"  {w}x{h}x{c}, payload {len(payload)} bytes, "
              f"{8 * len(data) / (w * h):.3f} bpp")
    return 0


def _cmd_selftest(args) -> int:
    """Golden-vector + cross-engine conformance check (SURVEY §4)."""
    from . import oracle

    golden = [
        (np.array([[[10, 20, 30]]], dtype=np.uint8),
         bytes.fromhex("790301000100" "8374be4365c6")),
        (np.array([[[0, 0, 0], [255, 255, 255]],
                   [[128, 64, 32], [1, 2, 3]]], dtype=np.uint8),
         bytes.fromhex("790302000200"
                       "8369acbe11430f72fa279a75645a50140baf6c")),
    ]
    failures = 0
    for img, expect in golden:
        if oracle.encode(img) != expect:
            print(f"FAIL golden encode {img.shape}", file=sys.stderr)
            failures += 1
        if not np.array_equal(oracle.decode(expect), img):
            print(f"FAIL golden decode {img.shape}", file=sys.stderr)
            failures += 1

    rng = np.random.default_rng(0)
    probe = np.clip(
        rng.integers(-3, 4, (24, 16, 3))
        + np.arange(16)[None, :, None] * 9 + 64, 0, 255
    ).astype(np.uint8)
    want = oracle.encode(probe)

    from . import dispatch
    from . import encode as jenc

    # the XLA engines run anywhere; the platform's device engine besides
    enc_engines = dict.fromkeys(["xla", dispatch.device_engine("encode")])
    dec_engines = dict.fromkeys(["decision",
                                 dispatch.device_engine("decode")])
    engines = {f"jax-{e}": (lambda e=e: jenc.encode_lanes(probe[None],
                                                          engine=e)[0])
               for e in enc_engines}
    try:
        from . import host

        engines["native"] = lambda: host.encode_stream(probe)
    except Exception:
        print("note: native engine unavailable (no C++ compiler)")
    for name, fn in engines.items():
        blob = fn()
        ok = blob == want[6:]
        print(f"{'ok  ' if ok else 'FAIL'} engine {name} byte-exact")
        failures += 0 if ok else 1

    from . import decode as jdec

    for dec_engine in dec_engines:
        out = jdec.decode_lanes([want[6:]], probe.shape, engine=dec_engine)
        ok = np.array_equal(out[0], probe)
        print(f"{'ok  ' if ok else 'FAIL'} decode engine {dec_engine}")
        failures += 0 if ok else 1

    print("selftest:", "PASS" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


def _cmd_corpus(args) -> int:
    import json

    from . import corpus
    from .io import load_image

    indir = pathlib.Path(args.indir)
    outdir = pathlib.Path(args.outdir) if args.outdir else indir
    outdir.mkdir(parents=True, exist_ok=True)
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm", ".pnm"}
    paths = sorted(p for p in indir.iterdir() if p.suffix.lower() in exts)
    if not paths:
        print(f"error: no images in {indir}", file=sys.stderr)
        return 1
    images = [load_image(p) for p in paths]
    blobs, stats = corpus.compress_corpus(images, slice_h=args.slice_h,
                                          backend="auto")
    for p, blob in zip(paths, blobs):
        (outdir / (p.name + EXT_SLICED)).write_bytes(blob)
    if args.verify:
        outs = corpus.decompress_corpus(blobs, backend="auto")
        bad = [p.name for p, a, b in zip(paths, outs, images)
               if not np.array_equal(a, b)]
        if bad:
            print(f"error: verify failed for {bad}", file=sys.stderr)
            return 1
        print(f"verified {len(paths)} images bit-exact")
    print(json.dumps(stats.as_dict()))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="llcomp", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress", help="image -> .llcomp/.llct")
    pc.add_argument("input")
    pc.add_argument("-o", "--output")
    pc.add_argument("--slices", default=None,
                    help="'auto' or stripe count; omit for reference format")
    pc.add_argument("--tile-w", dest="tile_w", default="auto",
                    help="column tile width for very wide images: 'auto' "
                         "(policy, default), 0 to disable, or a pixel "
                         "width (sliced mode only)")
    pc.add_argument("--backend", default="auto",
                    choices=["auto", "jax", "oracle", "native"])
    pc.add_argument("--revision", type=int, default=2, choices=[0, 2],
                    help="bitstream revision: 2 (default) or legacy 0 (llcomp.js)")
    pc.set_defaults(fn=_cmd_compress)

    pd = sub.add_parser("decompress", help=".llcomp/.llct -> image")
    pd.add_argument("input")
    pd.add_argument("-o", "--output")
    pd.add_argument("--backend", default="auto",
                    choices=["auto", "jax", "oracle", "native"])
    pd.set_defaults(fn=_cmd_decompress)

    pi = sub.add_parser("info", help="inspect a compressed file")
    pi.add_argument("input")
    pi.set_defaults(fn=_cmd_info)

    pb = sub.add_parser(
        "corpus", help="compress every image in a directory (batched lanes)"
    )
    pb.add_argument("indir")
    pb.add_argument("-o", "--outdir", default=None)
    pb.add_argument("--slice-h", type=int, default=8)
    pb.add_argument("--verify", action="store_true",
                    help="decode everything back and compare pixels")
    pb.set_defaults(fn=_cmd_corpus)

    ps = sub.add_parser("selftest", help="golden-vector conformance check")
    ps.set_defaults(fn=_cmd_selftest)

    args = p.parse_args(argv)
    from . import cache

    cache.enable()
    try:
        return args.fn(args)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
