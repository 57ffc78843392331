#!/usr/bin/env python3
"""Benchmark: batched sliced encode/decode throughput on the local GPU.

Prints ONE JSON line:
  {"metric": "encode_mps_512", "value": N, "unit": "MP/s", "vs_baseline": N,
   "device_kind": ..., "card": "<name>, <power limit>", ...}

Baseline: the C++ reference encodes 512x512x3 photo-like at 4.0 MP/s on one
CPU core (BASELINE.md).  The main configuration encodes a batch of
512x512x3 images cut into 8-row stripes, every stripe one lane of the
engine ``dispatch`` picks for this platform; times are end to end, from
host uint8 images to host bytes and back, on fresh batches.  A
round-trip-exactness gate zeroes vs_baseline on any mismatch.  The extra
geometries of BASELINE.md run in this same process, after the main one.

Needs a GPU: on any other platform it exits non-zero without a result.
Env knobs: BENCH_IMAGES (default 16), BENCH_SLICE_H (default 8),
BENCH_REPS (default 3), BENCH_EXTRA=0 to skip the extra geometries,
BENCH_DECODE=0 to skip decode.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# single-core reference MP/s per (size, channels) (BASELINE.md)
_REF_ENCODE = {(512, 3): 4.0, (2048, 3): 3.8, (1024, 3): 4.1, (256, 4): 2.5}
_REF_DECODE = {(512, 3): 3.5, (2048, 3): 3.1, (1024, 3): 3.4, (256, 4): 2.3}


def make_photo(h, w, c=3, seed=42, noise=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        128
        + 64 * np.sin(2 * np.pi * xx / w * 1.5)
        + 64 * np.cos(2 * np.pi * yy / h * 1.1)
    )
    img = base[..., None] + np.arange(c)[None, None, :] * 10.0
    img = img + rng.integers(-noise, noise + 1, size=(h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_natural(h, w, c=3, seed=42):
    """Multi-octave value noise: a 1/f-spectrum stand-in for real photos.

    The sinusoid corpus above has an unrealistically easy spectrum; natural
    images have power ~ 1/f^2 with broadband detail at every scale plus
    sensor noise, which is what this produces (correlated RGB, slight
    per-channel offsets, 1-LSB read noise).
    """
    rng = np.random.default_rng(seed)
    acc = np.zeros((h, w))
    size, amp = 4, 1.0
    while size <= max(h, w):
        g = rng.standard_normal((min(size, h), min(size, w)))
        gy = np.linspace(0, g.shape[0] - 1, h)
        gx = np.linspace(0, g.shape[1] - 1, w)
        iy, ix = gy.astype(int), gx.astype(int)
        fy, fx = (gy - iy)[:, None], (gx - ix)[None, :]
        iy1 = np.minimum(iy + 1, g.shape[0] - 1)
        ix1 = np.minimum(ix + 1, g.shape[1] - 1)
        up = (g[np.ix_(iy, ix)] * (1 - fy) * (1 - fx)
              + g[np.ix_(iy1, ix)] * fy * (1 - fx)
              + g[np.ix_(iy, ix1)] * (1 - fy) * fx
              + g[np.ix_(iy1, ix1)] * fy * fx)
        acc += amp * up
        size *= 2
        amp *= 0.55
    acc = (acc - acc.mean()) / max(acc.std(), 1e-9)
    lum = 128 + 52 * acc
    chroma = rng.standard_normal((1, 1, c)) * 14
    img = lum[..., None] + chroma + rng.integers(-1, 2, size=(h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def _card() -> str:
    """Name and power limit of the card, from a child that stays off JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


def _lanes(imgs, slice_h):
    H, W, C = imgs[0].shape
    return np.concatenate([im.reshape(H // slice_h, slice_h, W, C)
                           for im in imgs])


def run_config(H, W, CH, n_images, slice_h, reps=3, decode=True,
               primed=True, seeded=True) -> dict:
    """Encode (and decode) ``n_images`` HxWxCH photo-like images cut into
    ``slice_h``-row stripes on the platform's device engines.  The first
    pass compiles; each timed pass uses a fresh batch."""
    from llcomp_jax import decode as jdec
    from llcomp_jax import dispatch
    from llcomp_jax import encode as jenc

    enc_engine = dispatch.device_engine("encode")
    dec_engine = dispatch.device_engine("decode")
    imgs = [make_photo(H, W, c=CH, seed=100 + i) for i in range(n_images)]
    seed_tab = seed_blob = None
    if seeded:
        from llcomp_jax import seed as seedmod

        seed_tab = seedmod.derive_pooled(imgs[:8])
        seed_blob = seedmod.pack_blob(seed_tab)
    mp = n_images * H * W / 1e6
    shape = (slice_h, W, CH)

    def encode(lanes):
        return jenc.encode_lanes(lanes, engine=enc_engine, primed=primed,
                                 seed=seed_tab)

    def decode_(streams):
        return jdec.decode_lanes(streams, shape, engine=dec_engine,
                                 primed=primed, seed=seed_tab)

    lanes = _lanes(imgs, slice_h)
    t0 = time.perf_counter()
    streams = encode(lanes)
    compile_s = time.perf_counter() - t0
    enc_s, dec_s, ok = [], [], True
    dec_compile_s = None
    if decode:
        t0 = time.perf_counter()
        ok = np.array_equal(decode_(streams), lanes)
        dec_compile_s = time.perf_counter() - t0
    for r in range(reps):
        fresh = _lanes([make_photo(H, W, c=CH, seed=5000 + r * 97 + i)
                        for i in range(n_images)], slice_h)
        t0 = time.perf_counter()
        s = encode(fresh)
        enc_s.append(time.perf_counter() - t0)
        if decode:
            t0 = time.perf_counter()
            out = decode_(s)
            dec_s.append(time.perf_counter() - t0)
            ok = ok and np.array_equal(out, fresh)
    comp = sum(map(len, streams)) + (
        n_images * len(seed_blob) if seed_blob else 0)
    res = {
        "encode_engine": enc_engine,
        "encode_mps": round(mp / min(enc_s), 3),
        "encode_round_mps": [round(mp / t, 3) for t in enc_s],
        "encode_compile_s": round(compile_s - min(enc_s), 2),
        "compression_ratio": round(n_images * H * W * CH / comp, 3),
        "lanes": int(lanes.shape[0]),
        "images": n_images,
        "slice_h": slice_h,
    }
    if decode:
        res.update({
            "decode_engine": dec_engine,
            "decode_mps": round(mp / min(dec_s), 3),
            "decode_round_mps": [round(mp / t, 3) for t in dec_s],
            "decode_compile_s": round(dec_compile_s - min(dec_s), 2),
            "roundtrip_exact": bool(ok),
        })
    return res


def _native(H, W, CH) -> dict:
    from llcomp_jax import host

    imgs = np.stack([make_photo(H, W, c=CH, seed=7000 + i) for i in range(4)])
    n_enc = n_dec = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        streams = host.encode_images(imgs)
        n_enc = min(n_enc, time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = host.decode_streams(streams, (H, W, CH))
        n_dec = min(n_dec, time.perf_counter() - t0)
    assert np.array_equal(out, imgs)
    return {
        "native_encode_mps": round(4 * H * W / 1e6 / n_enc, 3),
        "native_decode_mps": round(4 * H * W / 1e6 / n_dec, 3),
        # single-stream ratio == the reference's own (bit-identical)
        "compression_ratio_singlestream": round(
            imgs.nbytes / sum(map(len, streams)), 3),
    }


def _natural_ratio(H, W, CH) -> dict:
    """Sliced, seeded ratio vs the single stream on the 1/f corpus."""
    from llcomp_jax import api, host
    from llcomp_jax import seed as seedmod

    nat = [make_natural(H, W, c=CH, seed=8200 + i) for i in range(8)]
    sh = api.pick_slice_height(H, W, CH)
    while H % sh:
        sh -= 1
    tab = seedmod.derive_pooled(nat)
    blob = seedmod.pack_blob(tab)
    raw = sum(im.nbytes for im in nat)
    sliced = host.encode_images(_lanes(nat, sh), primed=True, seed=tab)
    single = host.encode_images(np.stack(nat))
    return {
        "compression_ratio_natural": round(
            raw / (sum(map(len, sliced)) + len(nat) * len(blob)), 3),
        "natural_slice_h": sh,
        "compression_ratio_natural_singlestream": round(
            raw / sum(map(len, single)), 3),
    }


def main() -> int:
    import jax

    from llcomp_jax import cache

    cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    H = W = int(os.environ.get("BENCH_SIZE", "512"))
    CH = int(os.environ.get("BENCH_CHANNELS", "3"))
    n_images = int(os.environ.get("BENCH_IMAGES", "16"))
    slice_h = int(os.environ.get("BENCH_SLICE_H", "8"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    decode = os.environ.get("BENCH_DECODE", "1") != "0"

    main_cfg = run_config(H, W, CH, n_images, slice_h, reps, decode)
    enc_vs = main_cfg["encode_mps"] / _REF_ENCODE.get((H, CH), 4.0)
    result = {
        "metric": (f"encode_mps_{H}" if CH == 3 else f"encode_mps_{H}x{CH}"),
        "value": main_cfg["encode_mps"],
        "unit": "MP/s",
        "vs_baseline": round(enc_vs, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": _card(),
        **main_cfg,
    }
    if decode:
        dec_vs = main_cfg["decode_mps"] / _REF_DECODE.get((H, CH), 3.5)
        result["decode_vs_baseline"] = round(dec_vs, 3)
        # the headline gate is the worse direction, zeroed on a mismatch
        result["vs_baseline"] = (round(min(enc_vs, dec_vs), 3)
                                 if main_cfg["roundtrip_exact"] else 0.0)
    result.update(_native(H, W, CH))
    if os.environ.get("BENCH_EXTRA", "1") != "0" and CH == 3 and H == 512:
        # BASELINE.md's other geometries, at 8-row stripes; 256x8192x3 is
        # the ultra-wide case
        result["extra_configs"] = {
            f"{eh}x{ew}x{ec}": run_config(eh, ew, ec, n, slice_h, 2, decode)
            for eh, ew, ec, n in ((2048, 2048, 3, 2), (256, 256, 4, 32),
                                  (256, 8192, 3, 2))
        }
        result.update(_natural_ratio(H, W, CH))
    if os.environ.get("LLCT_PROFILE") == "1":
        from llcomp_jax import profiling

        result["stage_profile"] = profiling.stages.report()
    result["bench_wall_s"] = round(time.perf_counter() - t_start, 1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
