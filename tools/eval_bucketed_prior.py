#!/usr/bin/env python3
"""Evaluate hash-bucketed sliced-mode priors (ratio, oracle-exact, CPU).

The shipped constant prior (tables.PRIOR_SUB, one start state per substate)
recovers ~70% of the stripe-restart ratio loss.  This tool measures how much
more a prior that depends on the context hash recovers: the hash's low
component q11(l-tl) (and the next, q11(tl-t)) encode how locally "busy" the
neighborhood is, and busier contexts want a flatter zero-flag prior.

Bucket schemes tried (B = bucket count):
  sub        B=1    the shipped constant prior (baseline)
  h11        B=11   bucket = hash % 11            (q11(l-tl) + 5)
  h121       B=121  bucket = hash % 121           (two local gradients)
  h11c       B=11   like h11 but buckets with thin evidence fall back to sub

Derivation pools per-(bucket, substate) bit counts over the same synthetic
training corpus derive_prior.py uses (NOT the bench corpus), picks the state
whose STATE_PROB is nearest the pooled p1.  Evaluation encodes the bench
corpus (16x 512x512x3 photos as 8-row stripes) through the XLA engine with a
generalized reset map and reports exact compressed sizes.

Run: JAX_PLATFORMS=cpu python tools/eval_bucketed_prior.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import make_photo  # noqa: E402
from llcomp_jax import coder, encode as jenc, oracle  # noqa: E402
from llcomp_jax.core import tables, transform  # noqa: E402
from llcomp_jax.core.config import REV2 as cfg  # noqa: E402
from tools.derive_prior import make_train  # noqa: E402

SUBS = cfg.substates


# --------------------------------------------------------------------------
# Derivation: per-(bucket, substate) pooled bit counts -> start states
# --------------------------------------------------------------------------


def bucketed_counts(img, nbuckets):
    v = oracle.rct_forward(img)
    hash_, diff = oracle.context_and_residual(v, cfg)
    ctx, bit, valid = oracle.binarize(diff, cfg)
    hb = (hash_.reshape(-1)[:, None] % nbuckets).repeat(ctx.shape[1], axis=1)
    key = (hb * SUBS + ctx).astype(np.int64)[valid]
    b = bit[valid].astype(np.int64)
    size = nbuckets * SUBS
    n1 = np.bincount(key[b == 1], minlength=size)
    n0 = np.bincount(key[b == 0], minlength=size)
    return n0, n1


def derive_table(nbuckets, min_evidence=0):
    """Pool (bucket, substate) bit counts over the TRAINING corpus.

    The pool mixes the sinusoid set derive_prior.py uses with 1/f-spectrum
    natural-noise images (bench.make_natural, disjoint seeds from every
    benchmark corpus): the natural half taught the table broadband detail
    statistics worth ~+4% ratio on natural content at no cost on the
    sinusoid corpus (measured round 2).
    """
    from bench import make_natural

    n0 = np.zeros(nbuckets * SUBS, np.int64)
    n1 = np.zeros(nbuckets * SUBS, np.int64)
    i = 0
    for noise in (2, 4, 6, 10):
        for fx, fy in ((0.7, 1.9), (1.3, 0.4), (2.6, 2.1)):
            img = make_train(192, 192, 3, 7_000 + i, noise, fx, fy)
            a, b = bucketed_counts(img, nbuckets)
            n0 += a
            n1 += b
            i += 1
    for k in range(8):
        img = make_natural(192, 192, seed=40_000 + k)
        a, b = bucketed_counts(img, nbuckets)
        n0 += a
        n1 += b
    n = n0 + n1
    p1 = np.where(n > 0, 256.0 * n1 / np.maximum(n, 1), 128.0)
    prob = tables.STATE_PROB.astype(np.float64)
    states = np.argmin(
        np.abs(prob[None, :] - p1[:, None]), axis=1
    ).astype(np.uint8)
    # thin evidence -> fall back to the global per-substate prior
    fallback = np.tile(tables.PRIOR_SUB, nbuckets)
    states = np.where(n >= min_evidence, states, fallback).astype(np.uint8)
    return states.reshape(nbuckets, SUBS), n.reshape(nbuckets, SUBS)


# --------------------------------------------------------------------------
# Evaluation: XLA-engine encode with a generalized reset map
# --------------------------------------------------------------------------


def _prepass_mapped(compact, reset_map):
    """encode._probability_prepass with reset state = reset_map[cidx]."""
    S, cap = compact.shape
    flat = compact.reshape(-1)
    lane_off = (jnp.arange(S) * cap)[:, None]
    key = jnp.where(compact >= 0, compact >> 1, jnp.int32(1 << 22))
    order = jnp.argsort(key, axis=1, stable=True)
    sortedp = flat[(lane_off + order).reshape(-1)].reshape(S, cap)
    skey = jnp.where(sortedp >= 0, sortedp >> 1, -1)
    sbit = (sortedp & 1).astype(jnp.int32)
    prev = jnp.concatenate(
        [jnp.full((S, 1), -2, jnp.int32), skey[:, :-1]], axis=1
    )
    seg_start = skey != prev
    rst = jnp.asarray(reset_map)[jnp.clip(skey, 0, reset_map.shape[0] - 1)]

    def walk(state, xs):
        b, ss, r = xs
        st = jnp.where(ss, r.astype(jnp.int32), state.astype(jnp.int32))
        p = transform.STATE_PROB[st]
        ns = transform.NEXT_STATE[st * 2 + b].astype(jnp.uint8)
        return ns, p.astype(jnp.uint8)

    _, probs_sorted = jax.lax.scan(
        walk, jnp.zeros((S,), jnp.uint8), (sbit.T, seg_start.T, rst.T)
    )
    return (
        jnp.zeros((S * cap,), jnp.uint8)
        .at[(lane_off + order).reshape(-1)]
        .set(probs_sorted.T.reshape(-1))
        .reshape(S, cap)
    )


def encode_mapped(imgs, reset_map):
    """encode_lanes(engine='xla') with an arbitrary per-cidx reset map."""
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    counts = np.asarray(jenc._count(imgs, cfg))
    cap = jenc._bucket(int(counts.max()))
    compact = jenc._compact_decisions(jnp.asarray(imgs), cap, cfg)
    probs = _prepass_mapped(compact, reset_map)

    def step(cod, xs):
        p, prob = xs
        return coder.put_step(cod, (prob.astype(jnp.int32), p & 1, p >= 0))

    cod, (meta, runs) = jax.lax.scan(
        step, coder.encoder_init(imgs.shape[0]), (compact.T, probs.T)
    )
    fmeta, fruns = coder.finish_steps(cod)
    meta = jnp.concatenate([meta, fmeta])
    runs = jnp.concatenate([runs, fruns])
    return coder.expand_slots_batch(np.asarray(meta), np.asarray(runs))


def reset_map_from_table(tab):
    """[B, SUBS] table -> per-cidx reset map [num_states]."""
    B = tab.shape[0]
    nh = cfg.num_states // SUBS
    h = np.arange(nh)
    return np.ascontiguousarray(tab[h % B]).reshape(-1).astype(np.uint8)


def main():
    n_images = int(os.environ.get("EVAL_IMAGES", "8"))
    slice_h = int(os.environ.get("EVAL_SLICE_H", "8"))
    H = W = 512
    CH = 3
    imgs = np.concatenate(
        [make_photo(H, W, seed=100 + i).reshape(H // slice_h, slice_h, W, CH)
         for i in range(n_images)]
    )
    raw = n_images * H * W * CH

    schemes = {}
    schemes["cold"] = np.zeros(cfg.num_states, np.uint8)
    schemes["sub (const)"] = reset_map_from_table(tables.PRIOR_SUB[None, :])
    schemes["shipped"] = tables.prior_full(cfg.num_states)
    for name, B, minev in (("h11", 11, 0), ("h11c", 11, 4096),
                           ("h121", 121, 0), ("h121c", 121, 2048)):
        tab, n = derive_table(B, minev)
        schemes[name] = reset_map_from_table(tab)
        if os.environ.get("EVAL_SHOW_TABLES") == "1":
            print(f"-- {name}: evidence quartiles "
                  f"{np.percentile(n, [0, 25, 50, 75]).astype(int)}")
            print(tab)

    for name, m in schemes.items():
        t0 = time.time()
        streams = encode_mapped(imgs, m)
        total = sum(len(s) for s in streams)
        print(f"{name:14s} ratio {raw / total:.4f}  "
              f"({total} bytes, {time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
