#!/usr/bin/env python3
"""Measure PER-IMAGE stored-seed priors (ratio, oracle-exact, CPU).

The shipped prior (tables.PRIOR_TAB, flag bit 0) is a STATIC cross-image
table; round 2 measured a full per-image model seed recovering ~135% of the
stripe-restart loss but costing ~63 KB/image — which is a net LOSS at the
bench's 512x512 images (17% of the compressed size).  This tool measures the
cheap middle ground: a per-image seed bucketed like the shipped prior
(121 x 8 states = 968 B, or 605/1331 buckets), derived from the image's own
bit statistics, net of stored bytes (raw and zlib).

Run: JAX_PLATFORMS=cpu python tools/eval_stored_seed.py
Env: EVAL_IMAGES (8), EVAL_SLICE_H (8), EVAL_NATURAL=1 to use the 1/f corpus.
"""
from __future__ import annotations

import os
import sys
import time
import zlib

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_natural, make_photo  # noqa: E402
from llcomp_jax import oracle  # noqa: E402
from llcomp_jax.core import tables  # noqa: E402
from llcomp_jax.core.config import REV2 as cfg  # noqa: E402
from tools.eval_bucketed_prior import (  # noqa: E402
    bucketed_counts, encode_mapped, reset_map_from_table,
)

SUBS = cfg.substates


def per_image_table(img, nbuckets, min_evidence=512):
    """[B, SUBS] start states from the image's own pooled bit counts.

    Thin-evidence buckets fall back to the SHIPPED static prior (the
    derivation the decoder also knows), so the stored table is never worse
    than flag-bit-0 priming on sparse content.
    """
    n0, n1 = bucketed_counts(img, nbuckets)
    n = (n0 + n1).astype(np.float64)
    p1 = np.where(n > 0, 256.0 * n1 / np.maximum(n, 1), 128.0)
    prob = tables.STATE_PROB.astype(np.float64)
    states = np.argmin(np.abs(prob[None, :] - p1[:, None]), axis=1)
    fallback = tables.prior_full(nbuckets * SUBS, SUBS)
    return np.where(n >= min_evidence, states,
                    fallback).astype(np.uint8).reshape(nbuckets, SUBS)


def per_image_full(img, min_evidence=64):
    """Full per-context-row seed [num_states] (the 63 KB variant)."""
    v = oracle.rct_forward(img)
    hash_, diff = oracle.context_and_residual(v, cfg)
    ctx, bit, valid = oracle.binarize(diff, cfg)
    key = (hash_.reshape(-1)[:, None] * SUBS + ctx).astype(np.int64)[valid]
    b = bit[valid].astype(np.int64)
    n1 = np.bincount(key[b == 1], minlength=cfg.num_states)
    n0 = np.bincount(key[b == 0], minlength=cfg.num_states)
    n = (n0 + n1).astype(np.float64)
    p1 = np.where(n > 0, 256.0 * n1 / np.maximum(n, 1), 128.0)
    prob = tables.STATE_PROB.astype(np.float64)
    states = np.argmin(np.abs(prob[None, :] - p1[:, None]), axis=1)
    return np.where(n >= min_evidence, states,
                    tables.prior_full(cfg.num_states)).astype(np.uint8)


def main():
    n_images = int(os.environ.get("EVAL_IMAGES", "8"))
    slice_h = int(os.environ.get("EVAL_SLICE_H", "8"))
    H = W = 512
    CH = 3
    natural = os.environ.get("EVAL_NATURAL") == "1"
    mk = make_natural if natural else make_photo
    imgs = [mk(H, W, seed=100 + i) for i in range(n_images)]
    raw = n_images * H * W * CH

    def lanes_of(img):
        return img.reshape(H // slice_h, slice_h, W, CH)

    # baselines: shipped static prior + single-stream
    t0 = time.time()
    total = sum(
        sum(len(s) for s in encode_mapped(lanes_of(im),
                                          tables.prior_full(cfg.num_states)))
        for im in imgs
    )
    print(f"shipped static   ratio {raw/total:.4f} ({time.time()-t0:.0f}s)",
          flush=True)

    for name, B, minev in (("seed121", 121, 512), ("seed605", 605, 256),
                           ("seed1331", 1331, 128)):
        t0 = time.time()
        total = 0
        stored_raw = stored_z = 0
        for im in imgs:
            tab = per_image_table(im, B, minev)
            m = reset_map_from_table(tab)
            total += sum(len(s) for s in encode_mapped(lanes_of(im), m))
            stored_raw += tab.size
            stored_z += len(zlib.compress(tab.tobytes(), 6))
        print(f"{name:16s} ratio {raw/total:.4f} "
              f"net_raw {raw/(total+stored_raw):.4f} "
              f"net_z {raw/(total+stored_z):.4f} "
              f"(+{stored_raw//n_images}B/img raw, "
              f"{stored_z//n_images}B z; {time.time()-t0:.0f}s)", flush=True)

    # pooled corpus seed: ONE table derived from all images' counts, shared
    # by the whole batch (keeps the batched encode/decode kernel paths
    # single-table; each container still stores its copy)
    t0 = time.time()
    n0 = np.zeros(121 * SUBS, np.int64)
    n1 = np.zeros(121 * SUBS, np.int64)
    for im in imgs:
        a, b = bucketed_counts(im, 121)
        n0 += a
        n1 += b
    n = (n0 + n1).astype(np.float64)
    p1 = np.where(n > 0, 256.0 * n1 / np.maximum(n, 1), 128.0)
    prob = tables.STATE_PROB.astype(np.float64)
    states = np.argmin(np.abs(prob[None, :] - p1[:, None]), axis=1)
    tab = np.where(n >= 512, states,
                   tables.prior_full(121 * SUBS, SUBS)
                   ).astype(np.uint8).reshape(121, SUBS)
    m = reset_map_from_table(tab)
    z = len(zlib.compress(tab.tobytes(), 6))
    total = sum(
        sum(len(s) for s in encode_mapped(lanes_of(im), m)) for im in imgs
    )
    print(f"{'pooled121':16s} ratio {raw/total:.4f} "
          f"net_raw {raw/(total+968*n_images):.4f} "
          f"net_z {raw/(total+z*n_images):.4f} "
          f"(+968B/img raw, {z}B z; {time.time()-t0:.0f}s)", flush=True)

    t0 = time.time()
    total = stored_raw = stored_z = 0
    for im in imgs:
        m = per_image_full(im)
        total += sum(len(s) for s in encode_mapped(lanes_of(im), m))
        stored_raw += m.size
        stored_z += len(zlib.compress(m.tobytes(), 6))
    print(f"{'seedfull':16s} ratio {raw/total:.4f} "
          f"net_raw {raw/(total+stored_raw):.4f} "
          f"net_z {raw/(total+stored_z):.4f} "
          f"(+{stored_raw//n_images}B/img raw, {stored_z//n_images}B z; "
          f"{time.time()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
