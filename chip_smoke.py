"""GPU smoke test: the sliced codec's main path, once, on the card.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: only the sharded path

One process drives the card (a second JAX process would find its memory
taken).  Phases, each checked exactly (the codec is integer end to end):

* corpus: 32 images of 512x512x3 at 16-row stripes (1,024 lanes) through
  ``corpus.compress_corpus`` / ``decompress_corpus``;
* single images through ``api.compress(slices='auto')`` /
  ``api.decompress``: 2048x2048x3, 2048x2048x1, 32 x 256x256x4,
  24 x 768x512x3, 256x8192x3 (column-tiled by the auto policy);
* every container byte-equal to the native runtime's; one stream per
  geometry byte-equal to ``oracle``; ``backend='auto'`` must run the
  engine ``dispatch.pick`` names (``dispatch.RAN``), and each geometry
  also runs on the GPU engine and on native, both timed;
* the CLI on .ppm files; 1x64 and 64x1 images;
* a corrupt stripe: exactly the poisoned lane is flagged, every other lane
  stays exact;
* each kernel's first compile at each geometry, timed, with
  ``memory_analysis()``;
* GPU kernels vs the plain XLA engines, end to end, at 1,024 lanes of
  16x512x3 and at 2048x2048x3, compile time apart from run time;
* the ``gpu``-marked tests, through ``pytest.main`` in this process.

Content is generated from a seed.  The last line of standard output is one
JSON object, ``{"ok": true, "device": {...}}``, printed only when every
phase passed; any failure, or a host without a GPU, exits non-zero and
prints no result.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
RESULTS: dict = {"phases": {}}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """Name and power limit of the card, from a child that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


def photo(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Seeded photo-like content: smooth fields, edges and sensor noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f1, f2 = rng.uniform(0.004, 0.03, 2)
    base = (128 + 70 * np.sin(xx * f1 + seed) * np.cos(yy * f2)
            + 25 * np.sign(np.sin((xx + 2 * yy) * 0.01 + seed)))
    img = (base[..., None] + rng.uniform(-40, 40, c)
           + rng.normal(0, 3, (h, w, c)))
    return np.clip(img, 0, 255).astype(np.uint8)


class Phases:
    def __init__(self):
        self.failed: list[str] = []

    def run(self, name: str, fn, *args):
        log(f"--- {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:
            self.failed.append(name)
            log(f"FAIL {name}\n{traceback.format_exc()}")
            RESULTS["phases"][name] = {"ok": False}
            return None
        RESULTS["phases"].setdefault(name, {})
        RESULTS["phases"][name].update(
            ok=True, seconds=round(time.perf_counter() - t0, 3))
        return out


def _ran(direction: str) -> dict:
    from llcomp_jax import dispatch

    return {e: n for (d, e), n in dispatch.RAN.items() if d == direction}


def _expect_engine(direction: str, engine: str = "gpu") -> None:
    ran = _ran(direction)
    if set(ran) != {engine}:
        raise AssertionError(f"{direction} ran on {ran}, expected {engine}")


def _oracle_check(blob: bytes, img: np.ndarray) -> None:
    """Stream 0 of a sliced container against the NumPy oracle."""
    from llcomp_jax import container, oracle
    from llcomp_jax import seed as seedmod

    streams, W, H, C, slice_h, flags, seed_blob, tile_w = (
        container.unpack_sliced(blob))
    y0, y1, x0, x1 = container.tile_regions(W, H, slice_h, tile_w)[0]
    tab = seedmod.unpack_blob(seed_blob) if seed_blob else None
    want = oracle.encode_planes(
        oracle.rct_forward(img[y0:y1, x0:x1]),
        primed=bool(flags & container.FLAG_PRIMED), seed=tab)
    if streams[0] != want:
        raise AssertionError("stream 0 differs from the oracle")


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _lanes_of(blob: bytes) -> int:
    from llcomp_jax import container

    return len(container.unpack_sliced(blob)[0])


def phase_images(name: str, images: list[np.ndarray], expect: str) -> None:
    """api.compress / api.decompress with ``backend='auto'``, on the native
    runtime and on the GPU engine, all byte-equal and exact.  ``auto`` must
    run ``expect``, the engine ``dispatch.pick`` names for these
    containers; the GPU engine is timed on its second pass."""
    from llcomp_jax import api, dispatch

    def run(backend: str):
        dispatch.RAN.clear()
        blobs, t_enc = _timed(
            lambda: [api.compress(im, slices="auto", backend=backend)
                     for im in images])
        enc = set(_ran("encode"))
        outs, t_dec = _timed(
            lambda: [api.decompress(b, backend=backend) for b in blobs])
        return blobs, outs, t_enc, t_dec, enc, set(_ran("decode"))

    px = sum(im.shape[0] * im.shape[1] for im in images)
    row = RESULTS["phases"].setdefault(name, {})
    blobs, outs, t_enc, t_dec, enc, dec = run("auto")
    lanes = _lanes_of(blobs[0])
    want = {dispatch.pick(d, lanes) for d in ("encode", "decode")}
    if want != {expect}:
        raise AssertionError(f"dispatch.pick names {want} for {lanes} "
                             f"lanes, expected {expect}")
    if enc != want or dec != want:
        raise AssertionError(f"auto ran encode {enc}, decode {dec}; "
                             f"dispatch.pick names {want} for {lanes} lanes")
    auto = want.pop()
    times = {"auto": (t_enc, t_dec)}
    ref = blobs
    for engine, backend in (("native", "native"), ("gpu", "jax")):
        if engine == auto == "native":
            times[engine] = times["auto"]
            continue
        if engine == "gpu" and auto != "gpu":
            run(backend)            # the GPU engine's first pass here
        blobs, outs, t_enc, t_dec, enc, dec = run(backend)
        if enc != {engine} or dec != {engine}:
            raise AssertionError(f"backend={backend!r} ran {enc}, {dec}")
        times[engine] = (t_enc, t_dec)
        if blobs != ref:
            raise AssertionError(f"{engine} containers differ from auto's")
        for im, out in zip(images, outs):
            if not np.array_equal(out, im):
                raise AssertionError(f"{engine}: decoded pixels differ")
    _oracle_check(ref[0], images[0])
    row.update(images=len(images), shape=list(images[0].shape),
               lanes_per_container=lanes, auto_engine=auto,
               exact_native=True, exact_oracle=True,
               ratio=round(sum(im.nbytes for im in images)
                           / sum(map(len, ref)), 4))
    for engine, (te, td) in times.items():
        row[engine] = dict(encode_s=round(te, 4), decode_s=round(td, 4),
                           encode_mps=round(px / 1e6 / te, 2),
                           decode_mps=round(px / 1e6 / td, 2))
    log(json.dumps({name: row}))


def phase_corpus(images: list[np.ndarray]) -> None:
    """corpus.compress_corpus / decompress_corpus: ``auto`` must put the
    1,024 stripes on the GPU engine; the native runtime is timed beside
    it."""
    from llcomp_jax import corpus, dispatch

    row = RESULTS["phases"].setdefault("corpus", {})
    (native, _), t_nenc = _timed(corpus.compress_corpus, images, slice_h=16,
                                 backend="native")
    nouts, t_ndec = _timed(corpus.decompress_corpus, native,
                           backend="native")
    for rep in ("first", "warm"):
        dispatch.RAN.clear()
        (blobs, stats), t_enc = _timed(
            corpus.compress_corpus, images, slice_h=16, backend="auto")
        _expect_engine("encode")
        outs, t_dec = _timed(corpus.decompress_corpus, blobs, backend="auto")
        _expect_engine("decode")
    if blobs != native:
        raise AssertionError("corpus containers differ from native")
    for im, out, nout in zip(images, outs, nouts):
        if not (np.array_equal(out, im) and np.array_equal(nout, im)):
            raise AssertionError("corpus pixels differ")
    _oracle_check(blobs[0], images[0])
    px = sum(im.shape[0] * im.shape[1] for im in images)
    row.update(lanes=stats.lanes, auto_engine="gpu", exact_native=True,
               exact_oracle=True, ratio=round(stats.ratio, 4))
    for engine, te, td in (("gpu", t_enc, t_dec), ("native", t_nenc,
                                                   t_ndec)):
        row[engine] = dict(encode_s=round(te, 4), decode_s=round(td, 4),
                           encode_mps=round(px / 1e6 / te, 2),
                           decode_mps=round(px / 1e6 / td, 2))
    log(json.dumps({"corpus": row}))


def phase_edges() -> None:
    """1x64 and 64x1 images on the device path (explicit backend='jax',
    since auto sends so few stripes to native)."""
    from llcomp_jax import api, oracle

    for shape in ((1, 64, 3), (64, 1, 3), (1, 64, 1), (64, 1, 4)):
        im = photo(*shape, seed=sum(shape))
        blob = api.compress(im, slices="auto", backend="jax")
        if blob != api.compress(im, slices="auto", backend="native"):
            raise AssertionError(f"{shape}: differs from native")
        _oracle_check(blob, im)
        if not np.array_equal(api.decompress(blob, backend="jax"), im):
            raise AssertionError(f"{shape}: round trip")
        single = api.compress(im, backend="jax")
        if single != oracle.encode(im):
            raise AssertionError(f"{shape}: single stream differs")
    log("edges ok: 1x64, 64x1 (RGB, gray, RGBA)")


def phase_corrupt() -> None:
    """Poison one lane of a 1,024-lane batch: only it is flagged."""
    from llcomp_jax import decode, encode, host
    from tests.test_native import _malicious_stream

    lanes = np.stack([photo(16, 512, 3, seed=900 + i) for i in range(64)])
    lanes = np.concatenate([lanes] * 16)
    streams = encode.encode_lanes(lanes)
    if streams != host.encode_images(lanes):
        raise AssertionError("encode differs from native")
    streams[517] = _malicious_stream()
    out, bad = decode.decode_lanes(streams, lanes.shape[1:], errors="report")
    good = np.ones(len(lanes), bool)
    good[517] = False
    if bad != [517] or not np.array_equal(out[good], lanes[good]):
        raise AssertionError(f"flagged {bad}, expected [517]")
    # a crc-corrupt slice of a container is reported, the rest exact
    from llcomp_jax import api, container

    im = photo(512, 512, 3, seed=77)
    blob = bytearray(api.compress(im, slices="auto"))
    streams_c, W, H, C, sh, *_ = container.unpack_sliced(bytes(blob))
    off = bytes(blob).index(streams_c[5])
    blob[off + 3] ^= 0x5A
    img2, bad2 = api.decompress(bytes(blob), strict=False)
    if bad2 != [5] or not np.array_equal(
            np.delete(img2, np.s_[5 * sh:6 * sh], 0),
            np.delete(im, np.s_[5 * sh:6 * sh], 0)):
        raise AssertionError(f"container flagged {bad2}, expected [5]")
    log("corrupt ok: lane 517 of 1024 flagged alone; crc slice 5 isolated")


def phase_cli() -> None:
    """The CLI on .ppm files: a 1536x2048x3 image (1,536 one-row stripes,
    the GPU engine) and a 512x768x3 one (32 stripes, native on a
    multi-threaded host); each runs the engine ``dispatch.pick`` names."""
    from llcomp_jax import api, cli, dispatch
    from llcomp_jax.io.images import load_image, save_image

    ran = []
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as d:
        d = pathlib.Path(d)
        for k, (h, w) in enumerate(((1536, 2048), (512, 768))):
            im = photo(h, w, 3, seed=5 + k)
            src, llct, dst = (d / f"{k}.ppm", d / f"{k}.llct",
                              d / f"{k}.out.ppm")
            save_image(src, im)
            dispatch.RAN.clear()
            if cli.main(["compress", str(src), "--slices", "auto",
                         "-o", str(llct)]):
                raise AssertionError("cli compress failed")
            if cli.main(["decompress", str(llct), "-o", str(dst)]):
                raise AssertionError("cli decompress failed")
            lanes = len(api.container.unpack_sliced(llct.read_bytes())[0])
            _expect_engine("encode", dispatch.pick("encode", lanes))
            _expect_engine("decode", dispatch.pick("decode", lanes))
            if not np.array_equal(load_image(dst), im):
                raise AssertionError("cli round trip differs")
            ran.append(f"{h}x{w}x3: {lanes} stripes on "
                       f"{dispatch.pick('encode', lanes)}")
    if not ran[0].endswith("gpu"):
        raise AssertionError(f"the large image ran {ran[0]}")
    log(f"cli ok: {'; '.join(ran)}")


def _compile(jitted, *args, **kw) -> tuple[float, object]:
    """Seconds to trace, lower and compile ``jitted`` for these arguments
    (shapes are enough).  Each call site is a shape's first compile in
    this process; a run that wants cold figures starts with an empty
    persistent compile cache."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kw).compile()
    return time.perf_counter() - t0, compiled


def phase_kernel_vs_xla(name: str, lanes: np.ndarray) -> None:
    """End-to-end (host uint8 -> host bytes -> host uint8) GPU kernels
    against the plain XLA engines on the same lanes; compile time of the
    XLA engines measured apart (the kernels' is in the memory phase)."""
    import jax
    import jax.numpy as jnp

    from llcomp_jax import decode, encode
    from llcomp_jax.core.config import REV2

    row = RESULTS["phases"].setdefault(name, {})
    S, h, w, c = lanes.shape
    px = S * h * w
    cap = encode._bucket(int(np.asarray(encode._count(lanes)).max()))
    row["xla_encode_compile_s"] = round(_compile(
        encode._pipeline, jax.ShapeDtypeStruct(lanes.shape, jnp.uint8), cap,
        REV2, True, None)[0], 3)
    ref = None
    for enc, dec in (("gpu", "gpu"), ("xla", "decision")):
        s, _ = _timed(encode.encode_lanes, lanes, engine=enc, primed=True)
        s, t_enc = _timed(encode.encode_lanes, lanes, engine=enc,
                          primed=True)
        ref = ref or s
        if s != ref:
            raise AssertionError(f"{enc} bytes differ")
        if dec == "decision":
            chunk = min(S, 256)             # decode_lanes' XLA lane chunk
            dcap = decode._bucket_cap(max(map(len, s[:chunk])))
            row["xla_decode_compile_s"] = round(_compile(
                decode._decode_scan,
                jax.ShapeDtypeStruct((chunk, dcap), jnp.uint8), h, w, c,
                REV2, True, None)[0], 3)
        o, _ = _timed(decode.decode_lanes, s, (h, w, c), engine=dec,
                      primed=True)
        o, t_dec = _timed(decode.decode_lanes, s, (h, w, c), engine=dec,
                          primed=True)
        if not np.array_equal(o, lanes):
            raise AssertionError(f"{dec} decode differs")
        row[enc] = dict(encode_run_s=round(t_enc, 4),
                        encode_mps=round(px / 1e6 / t_enc, 3),
                        decode_engine=dec, decode_run_s=round(t_dec, 4),
                        decode_mps=round(px / 1e6 / t_dec, 3))
    row.update(lanes=S, stripe=[h, w, c],
               encode_speedup=round(row["xla"]["encode_run_s"]
                                    / row["gpu"]["encode_run_s"], 1),
               decode_speedup=round(row["xla"]["decode_run_s"]
                                    / row["gpu"]["decode_run_s"], 1))
    log(json.dumps({name: row}))


def phase_memory() -> None:
    """First compile of each kernel at each geometry's lane batch (lanes,
    stripe rows, width, channels): seconds to trace, lower and compile,
    and ``compiled.memory_analysis()``.  Decode is compiled at a stream
    cap of one byte per symbol, the corpus streams' order of size."""
    import jax
    import jax.numpy as jnp

    from llcomp_jax import decode, encode, kernels
    from llcomp_jax.core.config import REV2

    row = jnp.asarray(kernels.model_row(REV2, primed=True))
    out = RESULTS["phases"].setdefault("memory", {})
    for S, h, w, c in ((1024, 16, 512, 3), (2048, 1, 2048, 3),
                       (1024, 2, 2048, 1), (32, 8, 256, 4),
                       (32, 16, 768, 3), (1024, 1, 2048, 3)):
        n_sym = h * w * c
        imgs = jax.ShapeDtypeStruct((S, h, w, c), jnp.uint8)
        data = jax.ShapeDtypeStruct((S, decode._bucket_cap(n_sym)),
                                    jnp.uint8)
        geom = f"{S}x{h}x{w}x{c}"
        for name, (secs, compiled) in (
                ("encode", _compile(kernels.encode_device, imgs, row,
                                    outcap=encode._outcap(n_sym))),
                ("decode", _compile(kernels.decode_device, data, row, h, w,
                                    c))):
            m = compiled.memory_analysis()
            out[f"{name}_{geom}"] = dict(
                compile_s=round(secs, 3),
                temp_bytes=getattr(m, "temp_size_in_bytes", None))
            log(f"memory {name} {geom} (compile {secs:.3f} s): {m}")


class _Count:
    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call" and report.passed:
            self.passed += 1


def phase_gpu_tests() -> None:
    import pytest

    count = _Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests")], plugins=[count])
    RESULTS["phases"]["gpu_tests"] = {"passed": count.passed,
                                      "failed": count.failed,
                                      "skipped": count.skipped}
    if rc != 0 or count.failed or count.skipped or not count.passed:
        raise AssertionError(f"gpu tests: rc={rc} {vars(count)}")
    log(f"gpu tests ok: {count.passed} passed")


def phase_four(mesh, n_images: int = 32, size: int = 512,
               big_size: int = 2048) -> None:
    """Sharded containers over a 4-GPU lane mesh equal the single-device
    GPU-engine containers built in this process."""
    from llcomp_jax import api, corpus, dispatch, parallel

    images = [photo(size, size, 3, seed=i) for i in range(n_images)]
    single, _ = corpus.compress_corpus(images, slice_h=16, backend="jax",
                                       seeded=True)
    dispatch.RAN.clear()
    (sharded, _), t_enc = _timed(corpus.compress_corpus, images,
                                 slice_h=16, mesh=mesh, seeded=True)
    outs, t_dec = _timed(corpus.decompress_corpus, sharded, mesh=mesh)
    _expect_engine("encode")
    _expect_engine("decode")
    if sharded != single:
        raise AssertionError("sharded corpus containers differ")
    if not all(np.array_equal(a, b) for a, b in zip(outs, images)):
        raise AssertionError("sharded corpus pixels differ")
    big = photo(big_size, big_size, 3, seed=11)
    ref = api.compress(big, slices="auto", backend="jax")
    dispatch.RAN.clear()
    blob, t_big = _timed(parallel.compress_sharded, big, mesh)
    out, t_bigd = _timed(parallel.decompress_sharded, blob, mesh)
    _expect_engine("encode")
    _expect_engine("decode")
    if blob != ref:
        raise AssertionError("sharded image container differs")
    if not np.array_equal(out, big):
        raise AssertionError("sharded image pixels differ")
    row = dict(corpus_lanes=sum(len(api.container.unpack_sliced(b)[0])
                                for b in sharded),
               corpus_encode_s=round(t_enc, 4),
               corpus_decode_s=round(t_dec, 4),
               image_encode_s=round(t_big, 4),
               image_decode_s=round(t_bigd, 4), image_size=big_size,
               byte_equal_single_device=True)
    RESULTS["phases"].setdefault("four", {}).update(row)
    log(json.dumps({"four": row}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on a 4-GPU mesh")
    args = ap.parse_args()
    if not (ROOT / "llcomp_jax").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import jax

    from llcomp_jax import cache

    cache_dir = pathlib.Path(cache.enable()
                             or os.environ["JAX_COMPILATION_CACHE_DIR"])
    cached = len(list(cache_dir.iterdir())) if cache_dir.is_dir() else 0
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"needs {want} GPUs, found {len(devs)}", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    log(f"device_kind={devs[0].device_kind} count={len(devs)}")
    log(f"compile cache {cache_dir}: {cached} entries at start")
    RESULTS.update(card=card, device_kind=devs[0].device_kind,
                   count=len(devs), jax=jax.__version__,
                   compile_cache_entries_at_start=cached,
                   host_threads=os.cpu_count())
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    ph = Phases()
    t0 = time.perf_counter()
    if args.four:
        from llcomp_jax import parallel

        ph.run("four", phase_four, parallel.make_mesh(4))
        count = 4
    else:
        count = 1
        from llcomp_jax import dispatch

        # builds the native runtime on first use: done before any timing
        log(f"native runtime available: {dispatch.native_available()}")
        ph.run("memory", phase_memory)
        ph.run("corpus", phase_corpus,
               [photo(512, 512, 3, seed=i) for i in range(32)])
        ph.run("rgb_2048", phase_images, "rgb_2048",
               [photo(2048, 2048, 3, seed=1)], "gpu")
        ph.run("gray_2048", phase_images, "gray_2048",
               [photo(2048, 2048, 1, seed=2)], "gpu")
        ph.run("rgba_256", phase_images, "rgba_256",
               [photo(256, 256, 4, seed=100 + i) for i in range(32)],
               "native")
        ph.run("kodak", phase_images, "kodak",
               [photo(512, 768, 3, seed=200 + i) for i in range(24)],
               "native")
        ph.run("wide_8192", phase_images, "wide_8192",
               [photo(256, 8192, 3, seed=3)], "gpu")
        ph.run("edges", phase_edges)
        ph.run("cli", phase_cli)
        ph.run("corrupt", phase_corrupt)
        corpus_lanes = np.stack([photo(512, 512, 3, seed=i)
                                 for i in range(32)]).reshape(
                                     1024, 16, 512, 3)
        ph.run("vs_xla_1024x16x512x3", phase_kernel_vs_xla,
               "vs_xla_1024x16x512x3", corpus_lanes)
        big = photo(2048, 2048, 3, seed=1)
        ph.run("vs_xla_2048x2048x3", phase_kernel_vs_xla,
               "vs_xla_2048x2048x3", big.reshape(2048, 1, 2048, 3))
        ph.run("gpu_tests", phase_gpu_tests)
    RESULTS["seconds"] = round(time.perf_counter() - t0, 1)
    RESULTS["failed"] = ph.failed
    out = ROOT / "chiprun_out" / ("chip_smoke_four.json" if args.four
                                  else "chip_smoke.json")
    out.write_text(json.dumps(RESULTS, indent=1))
    if ph.failed:
        print(f"failed phases: {ph.failed}", file=sys.stderr)
        return 1
    log(f"all phases passed in {RESULTS['seconds']} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
