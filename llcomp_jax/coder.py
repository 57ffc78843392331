"""Lockstep-vectorized carry-less range coder (JAX).

One *lane* is one independent llcomp stream (an image or a stripe of one).
All lanes march through the bit-serial coder together: each `lax.scan` step
codes exactly one binary decision per lane with pure element-wise vector ops.

Two properties of the reference coder (`llcomp.hpp:33-127`) make a fixed-shape
formulation possible:

* ``range >= 1`` always holds after a ``put``, so renormalization shifts at
  most **once** per decision (`llcomp.hpp:38-58`) — every scan step does
  bounded work;
* the carry chain is *lazy*: a shift either (a) flushes the pending byte plus a
  same-valued run, (b) defers by counting, or (c) just installs a pending byte.
  Instead of emitting a variable number of bytes per step (impossible with
  static shapes), each step emits one fixed-size **slot record**
  ``(emit?, carry?, head byte, run length)``; the byte stream is recovered
  afterwards by a trivially-vectorized run expansion (`expand_slots``).

``put_step`` here is the model-free primitive (probability supplied per
decision); the baseline encode pipeline in ``encode.py`` wraps it with the
adaptive-model gather/update in the scan carry.  Because the encode-side model
walk is fully determined by the (precomputable) decision stream, a later
optimization can hoist the model out of the hot scan entirely and feed
precomputed probabilities straight into ``put_step``.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# --------------------------------------------------------------------------
# Shift (renormalization) step — mirrors renorm_encoder at llcomp.hpp:38-58
# --------------------------------------------------------------------------


def shift_step(low, rng, pend, run, do):
    """One renorm shift per lane where ``do`` is set.

    Returns updated (low, range, pending, run) and the slot record
    (emit flag, carry flag, head byte, flushed run length).
    """
    first = pend < 0
    nocarry = low <= 0xFF00
    carry = low >= 0x10000
    emit = do & ~first & (nocarry | carry)
    defer = do & ~first & ~nocarry & ~carry

    head = jnp.where(carry, (pend + 1) & 0xFF, pend & 0xFF)
    out_run = run                                     # flushed alongside head

    pend2 = jnp.where(do & ~defer, (low >> 8) & 0xFF, pend)
    run2 = jnp.where(emit, 0, jnp.where(defer, run + 1, run))
    low2 = jnp.where(do, (low & 0xFF) << 8, low)
    rng2 = jnp.where(do, rng << 8, rng)
    return (low2, rng2, pend2, run2), (emit, carry, head, out_run)


def pack_slot(emit, carry, head, out_run):
    """Slot record -> (meta int32, run int32).  meta = emit | carry<<1 | head<<8."""
    meta = (
        emit.astype(jnp.int32)
        | (carry.astype(jnp.int32) << 1)
        | (head.astype(jnp.int32) << 8)
    )
    return meta, out_run.astype(jnp.int32)


# --------------------------------------------------------------------------
# Encoder scan: probabilities precomputed, carry = 4 scalars per lane
# --------------------------------------------------------------------------


def encoder_init(n_lanes: int):
    zeros = jnp.zeros((n_lanes,), jnp.int32)
    return (zeros, jnp.full((n_lanes,), 0xFF00, jnp.int32),
            jnp.full((n_lanes,), -1, jnp.int32), zeros)


def put_step(carry, xs):
    """Code one decision per lane.  xs = (prob [S], bit [S], valid [S])."""
    low, rng, pend, run = carry
    prob, bit, valid = xs
    range1 = (rng * prob) >> 8
    is1 = (bit == 1) & valid
    low = jnp.where(is1, low + rng - range1, low)
    rng = jnp.where(valid, jnp.where(is1, range1, rng - range1), rng)
    do = valid & (rng < 0x100)
    (low, rng, pend, run), slot = shift_step(low, rng, pend, run, do)
    return (low, rng, pend, run), pack_slot(*slot)


def finish_steps(carry):
    """The two forced flush shifts of ``finish()`` (`llcomp.hpp:75-81`).

    The byte left pending afterwards is dropped, exactly as the reference
    does — the decoder reads zeros past end-of-stream.
    """
    low, rng, pend, run = carry
    t = jnp.ones_like(low, dtype=bool)
    low = low + 0xFF
    (low, rng, pend, run), slot1 = shift_step(low, jnp.full_like(rng, 0xFF), pend, run, t)
    (low, rng, pend, run), slot2 = shift_step(low, jnp.full_like(rng, 0xFF), pend, run, t)
    m1 = pack_slot(*slot1)
    m2 = pack_slot(*slot2)
    return (jnp.stack([m1[0], m2[0]]), jnp.stack([m1[1], m2[1]]))


# --------------------------------------------------------------------------
# Host-side slot expansion (NumPy; vectorized run-length fill)
# --------------------------------------------------------------------------


def expand_slots_batch(
    meta: np.ndarray, runs: np.ndarray, lane_major: bool = False
) -> list[bytes]:
    """[T, S] slot records -> per-lane byte streams, one vectorized pass.

    Lane-major flattening keeps each lane's slots contiguous, so a single
    np.repeat over all lanes followed by head-byte placement reconstructs
    every stream; per-lane totals split the result.  Pass ``lane_major=True``
    when the arrays are already [S, T].
    """
    if lane_major:
        m = np.ascontiguousarray(meta)
        r = np.ascontiguousarray(runs)
    else:
        m = np.ascontiguousarray(meta.T)     # [S, T]
        r = np.ascontiguousarray(runs.T)
    sel = (m & 1) == 1
    lens_all = np.where(sel, 1 + r.astype(np.int64), 0)
    per_lane = lens_all.sum(axis=1)

    sel_f = sel.reshape(-1)
    heads = ((m.reshape(-1)[sel_f] >> 8) & 0xFF).astype(np.uint8)
    fills = np.where(m.reshape(-1)[sel_f] & 2, 0x00, 0xFF).astype(np.uint8)
    lens = lens_all.reshape(-1)[sel_f]

    out = np.repeat(fills, lens)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    out[starts] = heads
    bounds = np.concatenate([[0], np.cumsum(per_lane)])
    return [out[bounds[s] : bounds[s + 1]].tobytes() for s in range(m.shape[0])]


def expand_slots(meta: np.ndarray, runs: np.ndarray) -> bytes:
    """[T] slot records of one lane -> the lane's byte stream.

    Each emitting slot contributes its head byte followed by ``run`` fill bytes
    (0xFF without carry, 0x00 with carry) — the same order the reference's
    renorm loop writes them.
    """
    sel = (meta & 1) == 1
    if not sel.any():
        return b""
    heads = ((meta[sel] >> 8) & 0xFF).astype(np.uint8)
    fills = np.where((meta[sel] & 2) != 0, 0x00, 0xFF).astype(np.uint8)
    lens = 1 + runs[sel].astype(np.int64)
    out = np.repeat(fills, lens)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    out[starts] = heads
    return out.tobytes()
