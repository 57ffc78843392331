"""Whole-batch vectorized precompute stages (JAX).

The encoder side of llcomp is only *serial* in the entropy coder: because the
codec is lossless, the "reconstructed" neighbors the reference reads from its
line ring buffer (`llcomp.hpp:417-422`) are exactly the forward-transformed
input samples.  That makes color transform, neighbor fetch, context hashing,
prediction, residual computation, sign folding and binarization pure
data-parallel maps over the whole batch of slices — one fused XLA program over
``[S, H, W, C]``, no loops.

All integer semantics (truncation toward zero, clamp-then-wrap table indexing)
match the reference bit-for-bit; see the NumPy oracle for the scalar spec.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp

from . import tables
from .config import REV2, CodecConfig

# Constant tables as device arrays (closed over by jit; broadcast once).
_QUANT5 = jnp.asarray(tables.QUANT5, dtype=jnp.int32)
_QUANT11 = jnp.asarray(tables.QUANT11, dtype=jnp.int32)
STATE_PROB = jnp.asarray(tables.STATE_PROB, dtype=jnp.int32)
NEXT_STATE = jnp.asarray(tables.NEXT_STATE, dtype=jnp.int32)


def trunc_div4(x: jnp.ndarray) -> jnp.ndarray:
    """C-style ``x / 4``: truncate toward zero (jnp ``//`` floors)."""
    return jnp.where(x >= 0, x // 4, -((-x) // 4))


def rct_forward(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 [..., C] -> int16 planes; C >= 3 applies the reversible transform."""
    v = img.astype(jnp.int32)
    if img.shape[-1] < 3:
        return v.astype(jnp.int16)
    r = v[..., 0] - v[..., 1]
    b = v[..., 2] - v[..., 1]
    g = v[..., 1] + trunc_div4(b + r)
    rest = v[..., 3:]
    return jnp.concatenate(
        [jnp.stack([r, g, b], axis=-1), rest], axis=-1
    ).astype(jnp.int16)


def rct_inverse(planes: jnp.ndarray) -> jnp.ndarray:
    """int planes [..., C] -> uint8 image (first 3 channels clamped)."""
    v = planes.astype(jnp.int32)
    if planes.shape[-1] < 3:
        return jnp.clip(v, 0, 255).astype(jnp.uint8)
    r, g0, b = v[..., 0], v[..., 1], v[..., 2]
    g = g0 - trunc_div4(r + b)
    r = r + g
    b = b + g
    rgb = jnp.clip(jnp.stack([r, g, b], axis=-1), 0, 255)
    return jnp.concatenate([rgb, v[..., 3:]], axis=-1).astype(jnp.uint8)


def _quant_arith(thresholds: tuple[int, ...], x: jnp.ndarray) -> jnp.ndarray:
    """Banded quantizer, arithmetically (bit-identical to the tables).

    The quant tables are generated from these bands (core/tables.py), so
    counting thresholds <= |clip(x)| reproduces them exactly — without a
    gather, which some XLA backends lower to a one-hot contraction that materializes
    [n_indices, 256] intermediates (tens of GB at production batch sizes).
    """
    y = jnp.clip(x, -128, 127)
    a = jnp.abs(y)
    mag = sum((a >= t).astype(jnp.int32) for t in thresholds)
    return jnp.sign(y) * mag


def _quant11(x: jnp.ndarray) -> jnp.ndarray:
    return _quant_arith((1, 2, 5, 12, 35), x)


def _quant5(x: jnp.ndarray) -> jnp.ndarray:
    return _quant_arith((1, 4), x)


def neighbors(v: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """(l, t, L, tl, tr, T) for int16 planes ``v`` of shape [S, H, W, C].

    Implemented as static shifts along H/W with boundary folds — identical to
    the reference ring-buffer reads, but for the whole batch at once.
    """
    x = v.astype(jnp.int32)
    S, H, W, C = x.shape

    def shift_w(a, n):  # left neighbor at distance n (pad on the left)
        return jnp.pad(a, ((0, 0), (0, 0), (n, 0), (0, 0)))[:, :, :W]

    def shift_h(a, n):  # top neighbor at distance n
        return jnp.pad(a, ((0, 0), (n, 0), (0, 0), (0, 0)))[:, :H]

    col = jax.lax.broadcasted_iota(jnp.int32, (1, 1, W, 1), 2)
    row = jax.lax.broadcasted_iota(jnp.int32, (1, H, 1, 1), 1)

    x_up = shift_h(x, 1)                       # V[h-1, w]
    l = jnp.where(col > 0, shift_w(x, 1), jnp.where(row > 0, x_up, 128))
    t = jnp.where(row > 0, x_up, l)
    L = jnp.where(col > 1, shift_w(x, 2), l)
    tl = jnp.where((row > 0) & (col > 0), shift_h(shift_w(x, 1), 1), t)
    # right-shifted previous row: V[h-1, w+1]
    x_up_r = jnp.pad(x_up, ((0, 0), (0, 0), (0, 1), (0, 0)))[:, :, 1:]
    tr = jnp.where((row > 0) & (col < W - 1), x_up_r, t)
    T = jnp.where(row > 1, shift_h(x, 2), t)
    return l, t, L, tl, tr, T


def context_and_residual(
    v: jnp.ndarray, cfg: CodecConfig = REV2
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Folded (hash, diff) per sample for planes [S, H, W, C] — `llcomp.hpp:424-436`."""
    l, t, L, tl, tr, T = neighbors(v)
    h = _quant11(l - tl) + _quant11(tl - t) * 11 + _quant11(t - tr) * 121
    if cfg.large_model:
        h = h + _quant5(L - l) * 605 + _quant5(T - t) * 3025
    predict = jnp.clip(l + t - tl, jnp.minimum(l, t), jnp.maximum(l, t))
    diff = v.astype(jnp.int32) - predict
    neg = h < 0
    return jnp.where(neg, -h, h), jnp.where(neg, -diff, diff)


def ilog2(uv: jnp.ndarray, max_bits: int = 16) -> jnp.ndarray:
    """floor(log2(uv)) for 1 <= uv < 2**max_bits, exact integer arithmetic."""
    e = jnp.zeros_like(uv)
    for j in range(1, max_bits):
        e = e + ((uv >> j) > 0).astype(uv.dtype)
    return e


def binarize(
    diff: jnp.ndarray, cfg: CodecConfig = REV2
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Residuals [S, N] -> per-slot (ctx, bit, valid, nbins).

    ctx/bit are [S, N, K] int32, valid [S, N, K] bool, nbins [S, N] int32 with
    K = 24 fixed slots (the 2e+3 <= 23 bound, SURVEY §2.4).  Mirrors
    ``putSymbol`` (`llcomp.hpp:166-206`); spec: oracle.binarize.
    """
    v = diff.astype(jnp.int32)
    uv = jnp.abs(v)
    nz = uv != 0
    e = ilog2(jnp.maximum(uv, 1))

    K = cfg.max_bins_per_symbol
    s = jax.lax.broadcasted_iota(jnp.int32, v.shape + (K,), v.ndim)
    e2 = e[..., None]
    uv2 = uv[..., None]

    in_exp = (s >= 1) & (s <= e2)
    is_stop = s == e2 + 1
    in_mant = (s >= e2 + 2) & (s <= 2 * e2 + 1)
    is_sign = s == 2 * e2 + 2

    ctx = jnp.zeros_like(s)
    bit = jnp.zeros_like(s)
    ctx = jnp.where(in_exp, jnp.minimum(s, cfg.e_lim), ctx)
    bit = jnp.where(in_exp, 1, bit)
    ctx = jnp.where(is_stop, jnp.minimum(e2 + 1, cfg.e_lim), ctx)
    ctx = jnp.where(in_mant, jnp.minimum(cfg.e_lim + 1 + (s - e2 - 2), cfg.r_lim), ctx)
    mant_i = jnp.maximum(2 * e2 + 1 - s, 0)
    bit = jnp.where(in_mant, (uv2 >> mant_i) & 1, bit)
    ctx = jnp.where(is_sign, cfg.sign_ctx, ctx)
    bit = jnp.where(is_sign, (v < 0)[..., None].astype(jnp.int32), bit)

    zero_slot = s == 0
    bit = jnp.where(zero_slot & ~nz[..., None], 1, bit)
    valid = zero_slot | (nz[..., None] & (in_exp | is_stop | in_mant | is_sign))
    nbins = jnp.where(nz, 2 * e + 3, 1)
    return ctx, bit, valid, nbins


def count_bins(diff: jnp.ndarray) -> jnp.ndarray:
    """Total binary decisions per slice [S] — without materializing the slots."""
    v = diff.reshape(diff.shape[0], -1).astype(jnp.int32)
    uv = jnp.abs(v)
    nbins = jnp.where(uv != 0, 2 * ilog2(jnp.maximum(uv, 1)) + 3, 1)
    return jnp.sum(nbins, axis=1)
