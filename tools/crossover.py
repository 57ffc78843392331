#!/usr/bin/env python3
"""GPU engine vs the threaded native runtime, engine level, over lane counts.

    python tools/crossover.py                 # on a GPU host
    python tools/crossover.py --interpret --shapes 2x8x3 --lanes 32
                                              # CPU dry run of the script

For each stripe shape and lane count it times, warm and best of ``--reps``:

* the GPU engine end to end (``encode.encode_lanes(engine='gpu')``: host
  uint8 -> host bytes; ``decode.decode_lanes(engine='gpu')``: bytes -> host
  uint8);
* the native runtime on every host thread, and on ``--threads`` fewer.

One JSON line per point; all points go to ``chiprun_out/crossover.json``.
``dispatch.GPU_LANES_PER_THREAD`` is read off these points: the lane count
per native thread from which the GPU engine finishes first.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def photo_lanes(n: int, h: int, w: int, c: int, seed: int) -> np.ndarray:
    """``n`` photo-like stripes of h x w x c cut from one seeded image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n * h, 0:w].astype(np.float32)
    base = (128 + 70 * np.sin(xx * 0.011 + seed) * np.cos(yy * 0.007)
            + 25 * np.sign(np.sin((xx + 2 * yy) * 0.01 + seed)))
    img = (base[..., None] + rng.uniform(-40, 40, c)
           + rng.normal(0, 3, (n * h, w, c)))
    return np.clip(img, 0, 255).astype(np.uint8).reshape(n, h, w, c)


def best(fn, reps: int) -> tuple[object, float]:
    out, t = None, float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        t = min(t, time.perf_counter() - t0)
    return out, t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="16x512x3,16x768x3,8x256x4,1x2048x3",
                    help="stripe shapes, HxWxC, comma-separated")
    ap.add_argument("--lanes", default="32,64,128,256,512,1024,2048")
    ap.add_argument("--threads", default="4,8",
                    help="native thread counts timed besides all threads")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--interpret", action="store_true",
                    help="run the GPU kernels in the Pallas interpreter")
    args = ap.parse_args()

    import jax

    from llcomp_jax import cache, decode, encode, host

    cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.interpret:
        print(f"needs a GPU (JAX found {dev.platform}); --interpret for a "
              "CPU dry run", file=sys.stderr)
        return 2
    all_threads = os.cpu_count() or 1
    threads = sorted({all_threads} | {int(t) for t in args.threads.split(",")
                                      if int(t) < all_threads})
    lane_counts = [int(n) for n in args.lanes.split(",")]
    points = []
    card = ""
    if dev.platform == "gpu":
        from chip_smoke import card_line

        card = card_line()
    head = {"device_kind": dev.device_kind, "card": card,
            "host_threads": all_threads}
    print(json.dumps(head), flush=True)
    for spec in args.shapes.split(","):
        h, w, c = (int(v) for v in spec.split("x"))
        pool = photo_lanes(max(lane_counts), h, w, c, seed=h * w + c)
        for n in lane_counts:
            lanes = pool[:n]
            gpu_enc = lambda: encode.encode_lanes(  # noqa: E731
                lanes, engine="gpu", primed=True, interpret=args.interpret)
            streams = gpu_enc()                      # compiles
            if streams != host.encode_images(lanes, primed=True):
                raise AssertionError(f"{spec} x{n}: gpu bytes differ")
            _, t_genc = best(gpu_enc, args.reps)
            gpu_dec = lambda: decode.decode_lanes(  # noqa: E731
                streams, (h, w, c), engine="gpu", primed=True,
                interpret=args.interpret)
            if not np.array_equal(gpu_dec(), lanes):  # compiles
                raise AssertionError(f"{spec} x{n}: gpu decode differs")
            _, t_gdec = best(gpu_dec, args.reps)
            row = {"shape": [h, w, c], "lanes": n, "symbols": h * w * c,
                   "gpu_encode_s": t_genc, "gpu_decode_s": t_gdec}
            for t in threads:
                _, row[f"native{t}_encode_s"] = best(
                    lambda: host.encode_images(lanes, t, primed=True),
                    args.reps)
                _, row[f"native{t}_decode_s"] = best(
                    lambda: host.decode_streams(streams, (h, w, c), t,
                                                primed=True), args.reps)
            points.append(row)
            print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "crossover.json").write_text(json.dumps(
        dict(head, points=points), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
