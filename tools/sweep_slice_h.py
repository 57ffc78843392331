"""Ratio-vs-throughput sweep over stripe heights (VERDICT r1 item 4).

Encodes the bench corpus (16x 512x512x3 photo-like images) at slice_h in
{8, 16, 32} on the platform's device engine and reports compression ratio
+ fresh-input encode MP/s per config, plus the single-stream ratio for
reference:

    python tools/sweep_slice_h.py

Timing discipline: one process per card, fresh inputs per timed rep.  A
rate is a device number only when the run was on a GPU.
"""
import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llcomp_jax import encode as jenc  # noqa: E402
from bench import make_photo  # noqa: E402

H = W = 512
N_IMG = 16
print("backend:", jax.default_backend(), flush=True)

raw = N_IMG * H * W * 3
mp_total = N_IMG * H * W / 1e6

for slice_h in (8, 16, 32):
    lanes0 = np.concatenate(
        [make_photo(H, W, seed=100 + i).reshape(H // slice_h, slice_h, W, 3)
         for i in range(N_IMG)]
    )
    t0 = time.time()
    streams = jenc.encode_lanes(lanes0)
    compile_s = time.time() - t0
    ratio = raw / sum(len(b) for b in streams)
    times = []
    for r in range(3):
        fb = np.concatenate(
            [make_photo(H, W, seed=9000 + 131 * slice_h + r * 17 + i)
             .reshape(H // slice_h, slice_h, W, 3) for i in range(N_IMG)]
        )
        t0 = time.time()
        jenc.encode_lanes(fb)
        times.append(time.time() - t0)
    best = min(times)
    print(f"slice_h={slice_h:3d} lanes={lanes0.shape[0]:5d} "
          f"ratio={ratio:.3f} single-batch {mp_total/best:.3f} MP/s "
          f"(compile {compile_s:.0f}s)", flush=True)

# single-stream reference ratio (one whole image per stream, 16 lanes)
imgs = np.stack([make_photo(H, W, seed=100 + i) for i in range(N_IMG)])
streams = jenc.encode_lanes(imgs, engine="xla")
print(f"single-stream ratio={raw / sum(len(b) for b in streams):.3f}",
      flush=True)
