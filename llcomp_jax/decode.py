"""Batched lane-parallel decoder (JAX).

Decoding is the serial heart of the format: every context hash depends on
just-reconstructed neighbor samples, and the number of coded decisions per
symbol is data-dependent (unknown until the unary exponent prefix
terminates).  Two engines, both bit-exact:

* **gpu** (``kernels.decode_device``): one Pallas/Triton kernel decoding
  one stream per thread, each with its own model in device memory.  The
  GPU engine of ``dispatch``.

* **decision-outer** (``_decode_impl``, the CPU device engine and the
  plain reference of the GPU kernel): one `lax.while_loop`
  iteration codes exactly one binary decision *per lane*, with each lane
  running its own little symbol state machine (zero-flag → unary exponent →
  mantissa → sign) and its own raster position.  Symbol-boundary work
  (neighbor fetch → context hash → prediction, then writeback of the
  reconstructed sample) piggybacks on the first/next decision's step.  Lanes
  drain at their natural pace and idle when finished; the loop ends when all
  lanes are done, so total iterations = max-over-lanes decision count
  (≈ 4.7/symbol on photo-like data) instead of the 24/symbol worst case.

The XLA engine uses flat 1-D gathers/scatters with absolute offsets.  The
inverse color transform commutes with reconstruction and is applied
vectorized at the end (the reference interleaves it per pixel,
`llcomp.hpp:532-540`).

Reference semantics: decode loop at `llcomp.hpp:486-545`; getSymbol mirror at
`llcomp.hpp:219-247`, including the exponent-over-31 corruption guard.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import dispatch, profiling
from .core import tables, transform
from .core.config import REV2, CodecConfig

# Symbol state-machine phases.
_ZF, _EXP, _MANT, _SIGN, _DONE = 0, 1, 2, 3, 4


def _init_states(S: int, cfg: CodecConfig, primed: bool, pad: int,
                 rstmap=None):
    """Per-lane model init: zeros (reference semantics), the sliced-mode
    hash-bucketed prior (tables.PRIOR_TAB, container flag bit 0), or a
    stored-seed reset map (flag bit 1, traced [num_states] u8); ``pad``
    trash slots per lane stay zero either way."""
    if rstmap is not None:
        row = jnp.concatenate(
            [jnp.asarray(rstmap, jnp.uint8), jnp.zeros((pad,), jnp.uint8)]
        )
        return jnp.tile(row, S)
    if not primed:
        return jnp.zeros((S * (cfg.num_states + pad),), jnp.uint8)
    row = np.concatenate([
        tables.prior_full(cfg.num_states, cfg.substates),
        np.zeros((pad,), np.uint8),
    ])
    return jnp.asarray(np.tile(row, S))


def _onehot_lut(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Small-table lookup as an int32 one-hot multiply-and-sum."""
    n = table.shape[0]
    oh = (idx[..., None] == jax.lax.broadcasted_iota(
        jnp.int32, idx.shape + (n,), idx.ndim)).astype(jnp.int32)
    return jnp.sum(oh * table, axis=-1)


def _quant_flat(table, x):
    return table[jnp.clip(x, -128, 127) & 0xFF]


# ===========================================================================
# Decision-outer engine
# ===========================================================================


def _decode_impl(data: jnp.ndarray, H: int, W: int, C: int,
                 cfg: CodecConfig = REV2, primed: bool = False,
                 rstmap=None):
    """data [S, cap] u8 (zero-padded) -> (planes [S, H, W, C] i32, err [S] bool)."""
    S, cap = data.shape
    NS = cfg.num_states
    stride = W * C
    n_sym = H * W * C
    d32 = data.astype(jnp.int32)
    dflat = d32.reshape(-1)
    data_base = jnp.arange(S) * cap
    model_base = jnp.arange(S) * (NS + 1)
    out_base = jnp.arange(S) * n_sym
    q11 = transform._QUANT11
    q5 = transform._QUANT5

    zero_i = jnp.zeros((S,), jnp.int32)

    def read_byte(pos):
        b = dflat[data_base + jnp.minimum(pos, cap - 1)]
        return jnp.where(pos < cap, b, 0)  # zero past end, like the reference

    def step(st):
        (states, out, low, rng, pos, k, i, w, h, phase, value, e,
         ectx, mrem, mctx, hsh_c, predict_c, neg_c, pending, recon_p, err,
         it) = st

        fin = k >= n_sym
        # ---- (a) writeback of a symbol completed last iteration ----------
        wb = pending & ~fin
        out = out.at[jnp.where(wb, out_base + k, S * n_sym)].set(
            recon_p, mode="drop"
        )
        # advance raster position for lanes that wrote back
        i2 = jnp.where(wb, i + 1, i)
        roll_i = wb & (i2 >= C)
        i2 = jnp.where(roll_i, 0, i2)
        w2 = jnp.where(roll_i, w + 1, w)
        roll_w = roll_i & (w2 >= W)
        w2 = jnp.where(roll_w, 0, w2)
        h2 = jnp.where(roll_w, h + 1, h)
        k2 = jnp.where(wb, k + 1, k)
        fin = k2 >= n_sym
        active = ~fin

        # ---- (b) context for lanes starting a new symbol -----------------
        # neighbors come straight from the output plane at fixed symbol-order
        # offsets from k (no separate line ring: one fewer per-lane scatter
        # each iteration)
        start = (pending | (it == 0)) & active
        w_pos = w2 > 0
        h_pos = h2 > 0

        def out_at(delta):
            return out[out_base + jnp.clip(k2 - delta, 0, n_sym - 1)]

        l = jnp.where(
            w_pos, out_at(C), jnp.where(h_pos, out_at(stride), 128)
        )
        t = jnp.where(h_pos, out_at(stride), l)
        L = jnp.where(w2 > 1, out_at(2 * C), l)
        tl = jnp.where(h_pos & w_pos, out_at(stride + C), t)
        tr = jnp.where(h_pos & (w2 < W - 1), out_at(stride - C), t)
        T = jnp.where(h2 > 1, out_at(2 * stride), t)

        hsh = (
            _quant_flat(q11, l - tl)
            + _quant_flat(q11, tl - t) * 11
            + _quant_flat(q11, t - tr) * 121
        )
        if cfg.large_model:
            hsh = hsh + _quant_flat(q5, L - l) * 605 + _quant_flat(q5, T - t) * 3025
        pred = jnp.clip(l + t - tl, jnp.minimum(l, t), jnp.maximum(l, t))
        neg = hsh < 0
        hsh = jnp.where(neg, -hsh, hsh)

        hsh_c2 = jnp.where(start, hsh * cfg.substates, hsh_c)
        predict_c2 = jnp.where(start, pred, predict_c)
        neg_c2 = jnp.where(start, neg, neg_c)
        phase = jnp.where(start, _ZF, phase)
        value = jnp.where(start, 0, value)
        e = jnp.where(start, 0, e)
        ectx = jnp.where(start, 1, ectx)
        mrem = jnp.where(start, 0, mrem)
        mctx = jnp.where(start, cfg.e_lim + 1, mctx)

        # ---- (c) one binary decision per active lane ---------------------
        ctx = jnp.where(phase == _EXP, jnp.minimum(ectx, cfg.e_lim), 0)
        ctx = jnp.where(phase == _MANT, jnp.minimum(mctx, cfg.r_lim), ctx)
        ctx = jnp.where(phase == _SIGN, cfg.sign_ctx, ctx)
        idx = model_base + jnp.where(active, hsh_c2 + ctx, NS)

        st8 = jnp.minimum(states[idx].astype(jnp.int32), 127)
        prob = _onehot_lut(transform.STATE_PROB, st8)
        range1 = (rng * prob) >> 8
        rng0 = rng - range1
        bit = (low >= rng0) & active
        low2 = jnp.where(bit, low - rng0, low)
        rng2 = jnp.where(active, jnp.where(bit, range1, rng0), rng)
        refill = active & (rng2 < 0x100)
        byte = read_byte(pos)
        low3 = jnp.where(refill, (low2 << 8) | byte, low2)
        rng3 = jnp.where(refill, rng2 << 8, rng2)
        pos2 = jnp.where(refill, pos + 1, pos)

        nst = _onehot_lut(transform.NEXT_STATE, st8 * 2 + bit.astype(jnp.int32))
        states = states.at[idx].set(nst.astype(jnp.uint8))

        b = bit.astype(jnp.int32)
        is_zf = (phase == _ZF) & active
        is_exp = (phase == _EXP) & active
        is_mant = (phase == _MANT) & active
        is_sign = (phase == _SIGN) & active

        value = jnp.where(is_zf, jnp.where(bit, 0, 1), value)
        value = jnp.where(is_mant, 2 * value + b, value)
        value = jnp.where(is_sign & bit, -value, value)

        e2 = jnp.where(is_exp & bit, e + 1, e)
        err = err | (e2 > 31)  # reference guard (`llcomp.hpp:232-234`)
        ectx2 = jnp.where(is_exp & bit, ectx + 1, ectx)
        mrem2 = jnp.where(is_exp & ~bit, e2, jnp.where(is_mant, mrem - 1, mrem))
        mctx2 = jnp.where(is_mant, mctx + 1, mctx)

        phase2 = phase
        phase2 = jnp.where(is_zf, jnp.where(bit, _DONE, _EXP), phase2)
        phase2 = jnp.where(is_exp & ~bit, jnp.where(e2 > 0, _MANT, _SIGN), phase2)
        phase2 = jnp.where(is_mant & (mrem == 1), _SIGN, phase2)
        phase2 = jnp.where(is_sign, _DONE, phase2)

        done_now = active & (phase2 == _DONE)
        diff = jnp.where(neg_c2, -value, value)
        recon_p2 = jnp.where(done_now, predict_c2 + diff, recon_p)

        return (states, out, low3, rng3, pos2, k2, i2, w2, h2,
                phase2, value, e2, ectx2, mrem2, mctx2, hsh_c2, predict_c2,
                neg_c2, done_now, recon_p2, err, it + 1)

    def cond(st):
        k, pending, err, it = st[5], st[18], st[20], st[21]
        unfinished = (k < n_sym) | pending
        # safety bound: a valid stream never exceeds 24 decisions/symbol
        return jnp.any(unfinished) & (it < n_sym * cfg.max_bins_per_symbol + 2)

    low0 = (d32[:, 0] << 8) | d32[:, 1]
    init = (
        _init_states(S, cfg, primed, 1, rstmap),      # states
        jnp.zeros((S * n_sym,), jnp.int32),           # out
        low0,                                         # low
        jnp.full((S,), 0xFF00, jnp.int32),            # range
        jnp.full((S,), 2, jnp.int32),                 # pos
        zero_i, zero_i, zero_i, zero_i,               # k, i, w, h
        jnp.full((S,), _DONE, jnp.int32),             # phase
        zero_i, zero_i, jnp.ones((S,), jnp.int32),    # value, e, ectx
        zero_i, jnp.full((S,), cfg.e_lim + 1, jnp.int32),  # mrem, mctx
        zero_i, zero_i, jnp.zeros((S,), bool),        # hash, predict, neg
        jnp.zeros((S,), bool),                        # pending writeback
        zero_i,                                       # recon pending
        jnp.zeros((S,), bool),                        # err
        jnp.zeros((), jnp.int32),                     # iteration counter
    )
    final = jax.lax.while_loop(cond, step, init)
    out, err = final[1], final[20]
    # a lane that hit the iteration bound without finishing is corrupt
    err = err | (final[5] < n_sym)
    planes = out.reshape(S, H, W, C)
    return planes, err


_decode_scan = jax.jit(
    _decode_impl, static_argnames=("H", "W", "C", "cfg", "primed")
)


def _bucket_cap(n: int, quantum: int = 4096) -> int:
    return max(quantum, -(-(n + 64) // quantum) * quantum)


def _pack_streams(streams: list[bytes], cap: int,
                  rows: int | None = None) -> np.ndarray:
    """Streams -> zero-padded u8 [rows, cap] (rows >= len(streams))."""
    data = np.zeros((rows or len(streams), cap), dtype=np.uint8)
    for s, blob in enumerate(streams):
        data[s, : len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    return data


def _decode_lanes_gpu(
    streams: list[bytes], shape: tuple[int, int, int], cfg: CodecConfig,
    primed: bool, seed, interpret: bool,
) -> tuple[np.ndarray, np.ndarray]:
    from . import encode, kernels

    H, W, C = shape
    S = len(streams)
    n_sym = H * W * C
    row = jnp.asarray(kernels.model_row(cfg, primed, seed))
    cap = _bucket_cap(max((len(s) for s in streams), default=0))
    # per lane: model, stream bytes, decoded planes and their u8 copy
    per_lane = 4 * row.shape[0] + cap + 9 * n_sym
    parts, errs = [], []
    for a, b in encode._lane_chunks(S, per_lane):
        dev = profiling.timed("decode/upload", jax.device_put,
                              _pack_streams(streams[a:b], cap))
        imgs, err = profiling.timed(
            "decode/kernel", kernels.decode_device, dev, row, H, W, C,
            cfg=cfg, interpret=interpret)
        parts.append(profiling.timed("decode/download", np.asarray, imgs))
        errs.append(np.asarray(err))
    return np.concatenate(parts), np.concatenate(errs)


def decode_lanes(
    streams: list[bytes], shape: tuple[int, int, int], cfg: CodecConfig = REV2,
    engine: str = "auto", primed: bool = False, errors: str = "raise",
    seed=None, interpret: bool = False,
) -> np.ndarray:
    """Decode equal-geometry headerless streams -> images [S, H, W, C] u8.

    engine: 'gpu' (the GPU kernel), 'decision' (the XLA while_loop), or
    'auto' (the platform's device engine, ``dispatch.device_engine``).
    primed: start context row h at the hash-bucketed prior
    tables.PRIOR_TAB[h % 121] instead of zeros (sliced containers with
    flag bit 0; see tools/derive_prior.py).
    seed: optional [121, 8] u8 stored-seed bucket table (flag bit 1)
    replacing the static prior values; one table per call.
    errors: 'raise' (default) raises ValueError if any lane's stream is
    corrupt; 'report' instead returns ``(images, bad_lanes)`` where
    ``bad_lanes`` lists the flagged lane indices and every *good* lane's
    pixels are intact — one corrupt stripe costs one stripe, not the batch
    (the container's per-slice independence exists for exactly this;
    repair via api.reencode_slice).
    interpret: run the GPU kernel in the Pallas interpreter (tests).
    """
    H, W, C = shape
    S = len(streams)
    if errors not in ("raise", "report"):
        raise ValueError(f"errors must be 'raise' or 'report', got {errors!r}")
    if engine == "auto":
        engine = dispatch.device_engine("decode")
    if engine not in ("gpu", "decision"):
        raise ValueError(f"unknown decode engine {engine!r}")
    dispatch.record("decode", engine, S)
    if engine == "gpu":
        out, lane_err = _decode_lanes_gpu(streams, shape, cfg, primed, seed,
                                          interpret)
        bad = np.nonzero(lane_err)[0].tolist()
    else:
        # a smaller chunk shortens the max-over-lanes straggler tail of the
        # while_loop; all chunks are dispatched before any is synced so
        # the device queue stays full
        MAX_LANES = 256
        rstmap = (jnp.asarray(tables.prior_full_from(
            seed, cfg.num_states, cfg.substates))
            if seed is not None else None)
        inflight = []
        for i in range(0, S, MAX_LANES):
            chunk = streams[i : i + MAX_LANES]
            cap = _bucket_cap(max((len(s) for s in chunk), default=0))
            planes, err = _decode_scan(jnp.asarray(_pack_streams(chunk, cap)),
                                       H, W, C, cfg, primed, rstmap)
            inflight.append((i, transform.rct_inverse(planes), err))
        parts, bad = [], []
        for i, imgs, err in inflight:
            bad.extend((np.nonzero(np.asarray(err))[0] + i).tolist())
            parts.append(np.asarray(imgs))
        out = np.concatenate(parts)
    if errors == "report":
        return out, bad
    if bad:
        raise ValueError(f"corrupt stream in lanes {bad}")
    return out
