"""GPU entropy kernels: one stripe stream per thread (Pallas through Triton).

The entropy stage is a serial chain per stream: every binary decision reads
and rewrites one byte of that stream's adaptive model and moves its range
coder.  Streams are independent, so the kernels run one stream per lane of
a program (``LANES`` lanes per program, one warp): the model lives in
device memory as packed words (7,926 context rows x 8 one-byte sub-states,
two int32 words per row), a row is read once per symbol and written back
after it, and the coder state stays in registers.

* ``encode_device``: the transform precompute (hash, folded residual) is
  plain XLA; the kernel walks each stream's symbols, binarizes on the fly
  and range-codes, storing every resolved byte directly at its lane's
  offset.  A byte is final once written: the carry that can still change
  the pending byte and its run of 0xFF bytes is applied when they resolve.
  Output size is bounded by ``encode._outcap``, so nothing overflows.
* ``decode_device``: per symbol, the neighbours come from the planes
  already decoded (recent ones from a register history), then the symbol's
  decisions are decoded.  A lane whose exponent prefix exceeds 31 sets its
  error flag (`llcomp.hpp:232-234`); other lanes are unaffected.  The
  inverse color transform is left to XLA.

Reference semantics: encode loop `llcomp.hpp:390-449`, decode loop
`llcomp.hpp:486-545`; ``native/llcomp_host.cpp`` is the scalar twin.

``interpret=True`` runs the kernels in the Pallas interpreter (CPU tests);
it is only ever set by an explicit caller argument.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .core import tables, transform
from .core.config import REV2, CodecConfig

#: lanes (streams) per program; one warp.
LANES = 32
NUM_WARPS = 1

_ZF, _EXP, _MANT, _SIGN, _DONE = 0, 1, 2, 3, 4
_DIFF_BIAS = 2048          # |diff| <= 1274 < 2048 (config.max_bins_per_symbol)


def model_row(cfg: CodecConfig = REV2, primed: bool = False,
              seed=None) -> np.ndarray:
    """Initial model of one lane as int32 words, 4 sub-states per word.

    Zeros (reference start), the hash-bucketed prior (container flag bit
    0) or a stored-seed table (flag bit 1)."""
    if cfg.substates != 8:
        raise ValueError("the GPU kernels pack 8 sub-states per context row")
    if seed is not None:
        row = tables.prior_full_from(seed, cfg.num_states, cfg.substates)
    elif primed:
        row = tables.prior_full(cfg.num_states, cfg.substates)
    else:
        row = np.zeros(cfg.num_states, np.uint8)
    return np.ascontiguousarray(row, dtype=np.uint8).view("<i4").copy()


def _pad_lanes(x, S: int):
    Sp = -(-S // LANES) * LANES
    if Sp == S:
        return x
    return jnp.pad(x, [(0, Sp - S)] + [(0, 0)] * (x.ndim - 1))


def _get_sub(w0, w1, slot):
    word = jnp.where(slot < 4, w0, w1)
    return (word >> ((slot & 3) * 8)) & 0xFF


def _set_sub(w0, w1, slot, val, on):
    sh = (slot & 3) * 8
    lo = on & (slot < 4)
    hi = on & (slot >= 4)
    w0 = jnp.where(lo, (w0 & ~(0xFF << sh)) | (val << sh), w0)
    w1 = jnp.where(hi, (w1 & ~(0xFF << sh)) | (val << sh), w1)
    return w0, w1


def _params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


# ---------------------------------------------------------------- encode --


def _encode_kernel(prob_ref, next_ref, xs_ref, _m_in, m_ref, out_ref,
                   len_ref, *, cfg: CodecConfig, outcap: int):
    n_sym = xs_ref.shape[0]
    lane = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
    zero = jnp.zeros((LANES,), jnp.int32)

    def put_byte(pos, val, on):
        plgpu.store(out_ref.at[lane, jnp.clip(pos, 0, outcap - 1)],
                    val.astype(jnp.uint8), mask=on & (pos < outcap))

    def shift(st, on):
        """Range-coder byte shift for lanes ``on`` (`Enc::shift`)."""
        low, rng, pend, run, opos = st
        first = on & (pend < 0)
        plain = on & ~first & (low <= 0xFF00)
        carry = on & ~first & (low >= 0x10000)
        defer = on & ~first & ~plain & ~carry
        resolve = plain | carry
        put_byte(opos, jnp.where(carry, pend + 1, pend), resolve)
        # run bytes were stored as 0xFF when deferred; a carry turns them
        # to 0x00 (rare: needs a carry right after a run of 0xFF bytes)
        fix = jnp.where(carry, run, 0)

        def fix_body(c):
            j = c
            put_byte(opos + 1 + j, zero, j < fix)
            return j + 1

        jax.lax.while_loop(lambda j: jnp.max(fix - j) > 0, fix_body, zero)
        put_byte(opos + 1 + run, jnp.full((LANES,), 0xFF, jnp.int32), defer)
        opos = jnp.where(resolve, opos + 1 + run, opos)
        run = jnp.where(resolve, 0, jnp.where(defer, run + 1, run))
        pend = jnp.where(first | plain, low >> 8,
                         jnp.where(carry, (low >> 8) & 0xFF, pend))
        low = jnp.where(on, (low & 0xFF) << 8, low)
        rng = jnp.where(on, rng << 8, rng)
        return low, rng, pend, run, opos

    def symbol(s, st):
        x = xs_ref[s, lane]
        h = x >> 12
        v = (x & 0xFFF) - _DIFF_BIAS
        mag = jnp.abs(v)
        e = zero
        for j in range(1, 12):
            e = e + ((mag >> j) > 0).astype(jnp.int32)
        nb = jnp.where(v == 0, 1, 2 * e + 3)
        w0 = m_ref[lane, 2 * h]
        w1 = m_ref[lane, 2 * h + 1]

        def decision(c):
            k, w0, w1, coder = c
            low, rng, pend, run, opos = coder
            act = k < nb
            is_exp = (k >= 1) & (k <= e)
            is_stop = k == e + 1
            is_mant = (k >= e + 2) & (k <= 2 * e + 1)
            is_sign = (k == 2 * e + 2) & (v != 0)
            slot = jnp.where(is_exp | is_stop, jnp.minimum(k, cfg.e_lim), 0)
            slot = jnp.where(
                is_mant, jnp.minimum(cfg.e_lim + k - e - 1, cfg.r_lim), slot)
            slot = jnp.where(is_sign, cfg.sign_ctx, slot)
            bit = jnp.where(k == 0, (v == 0).astype(jnp.int32), 1)
            bit = jnp.where(is_stop, 0, bit)
            bit = jnp.where(is_mant,
                            (mag >> jnp.maximum(2 * e + 1 - k, 0)) & 1, bit)
            bit = jnp.where(is_sign, (v < 0).astype(jnp.int32), bit)
            sub = _get_sub(w0, w1, slot)
            prob = prob_ref[sub]
            r1 = (rng * prob) >> 8
            one = act & (bit == 1)
            low = jnp.where(one, low + rng - r1, low)
            rng = jnp.where(act, jnp.where(one, r1, rng - r1), rng)
            coder = shift((low, rng, pend, run, opos), act & (rng < 0x100))
            w0, w1 = _set_sub(w0, w1, slot, next_ref[sub * 2 + bit], act)
            return k + 1, w0, w1, coder

        kmax = jnp.max(nb)
        _, w0, w1, st = jax.lax.while_loop(
            lambda c: c[0] < kmax, decision, (jnp.int32(0), w0, w1, st))
        m_ref[lane, 2 * h] = w0
        m_ref[lane, 2 * h + 1] = w1
        return st

    st = (zero, jnp.full((LANES,), 0xFF00, jnp.int32),
          jnp.full((LANES,), -1, jnp.int32), zero, zero)
    st = jax.lax.fori_loop(0, n_sym, symbol, st)
    # flush (`Enc::flush`): two forced shifts; the pending byte is dropped
    low, rng, pend, run, opos = st
    everyone = jnp.ones((LANES,), bool)
    st = shift((low + 0xFF, jnp.full_like(rng, 0xFF), pend, run, opos),
               everyone)
    low, rng, pend, run, opos = st
    _, _, _, _, opos = shift((low, jnp.full_like(rng, 0xFF), pend, run, opos),
                             everyone)
    len_ref[lane] = opos


def _precompute(imgs, cfg: CodecConfig):
    """u8 [S, H, W, C] -> packed (hash << 12 | diff + bias) [n_sym, S]."""
    S = imgs.shape[0]
    v = transform.rct_forward(imgs)
    h, d = transform.context_and_residual(v, cfg)
    xs = (h << 12) | (d + _DIFF_BIAS)
    return xs.reshape(S, -1).T


@functools.partial(jax.jit,
                   static_argnames=("outcap", "cfg", "interpret"))
def encode_device(imgs, row, outcap: int, cfg: CodecConfig = REV2,
                  interpret: bool = False):
    """Encode lanes on the device.

    imgs u8 [S, H, W, C], row int32 [num_states/4] (``model_row``) ->
    (bytes u8 [S, outcap], lens int32 [S]); lane s's stream is
    ``bytes[s, :lens[s]]``."""
    S = imgs.shape[0]
    imgs = _pad_lanes(imgs, S)
    Sp = imgs.shape[0]
    xs = _precompute(imgs, cfg)
    model = jnp.broadcast_to(row[None, :], (Sp, row.shape[0]))
    kernel = functools.partial(_encode_kernel, cfg=cfg, outcap=outcap)
    _, out, lens = pl.pallas_call(
        kernel,
        grid=(Sp // LANES,),
        out_shape=(
            jax.ShapeDtypeStruct(model.shape, jnp.int32),
            jax.ShapeDtypeStruct((Sp, outcap), jnp.uint8),
            jax.ShapeDtypeStruct((Sp,), jnp.int32),
        ),
        input_output_aliases={3: 0},
        interpret=interpret,
        backend="triton",
        compiler_params=_params(),
        name="llcomp_encode",
    )(transform.STATE_PROB, transform.NEXT_STATE, xs, model)
    return out[:S], lens[:S]


# ---------------------------------------------------------------- decode --


def _decode_kernel(prob_ref, next_ref, data_ref, _m_in, m_ref, out_ref,
                   err_ref, *, H: int, W: int, C: int, cfg: CodecConfig):
    cap = data_ref.shape[1]
    stride = W * C
    n_sym = H * stride
    hist_n = 2 * C            # decoded values kept in registers
    lane = pl.program_id(0) * LANES + jnp.arange(LANES, dtype=jnp.int32)
    zero = jnp.zeros((LANES,), jnp.int32)

    def byte_at(pos, on):
        b = plgpu.load(data_ref.at[lane, jnp.clip(pos, 0, cap - 1)],
                       mask=on & (pos < cap), other=0)
        return jnp.where(on & (pos < cap), b.astype(jnp.int32), 0)

    def symbol(k, st):
        low, rng, pos, err, hist = st
        # k >= 0: truncating lax division is floor division here
        w = jax.lax.rem(jax.lax.div(k, C), W)
        h = jax.lax.div(k, stride)

        def back(off):
            """Decoded value ``off`` symbols back (caller masks validity)."""
            if off <= 0:
                return zero
            if off <= hist_n:
                return hist[off - 1]
            return out_ref[jnp.maximum(k - off, 0), lane]

        up = back(stride)
        l = jnp.where(w > 0, back(C), jnp.where(h > 0, up, 128))
        t = jnp.where(h > 0, up, l)
        L = jnp.where(w > 1, back(2 * C), l)
        tl = jnp.where((h > 0) & (w > 0), back(stride + C), t)
        tr = jnp.where((h > 0) & (w < W - 1), back(stride - C), t)
        T = jnp.where(h > 1, back(2 * stride), t)
        q11, q5 = transform._quant11, transform._quant5
        hsh = q11(l - tl) + q11(tl - t) * 11 + q11(t - tr) * 121
        if cfg.large_model:
            hsh = hsh + q5(L - l) * 605 + q5(T - t) * 3025
        pred = jnp.clip(l + t - tl, jnp.minimum(l, t), jnp.maximum(l, t))
        neg = hsh < 0
        hsh = jnp.abs(hsh)
        w0 = m_ref[lane, 2 * hsh]
        w1 = m_ref[lane, 2 * hsh + 1]

        def decision(c):
            (w0, w1, low, rng, pos, phase, value, e, j, err) = c
            act = phase != _DONE
            slot = jnp.where(phase == _EXP, jnp.minimum(e + 1, cfg.e_lim), 0)
            slot = jnp.where(phase == _MANT,
                             jnp.minimum(cfg.e_lim + 1 + j, cfg.r_lim), slot)
            slot = jnp.where(phase == _SIGN, cfg.sign_ctx, slot)
            sub = _get_sub(w0, w1, slot)
            prob = prob_ref[sub]
            r1 = (rng * prob) >> 8
            rng0 = rng - r1
            one = act & (low >= rng0)
            low = jnp.where(one, low - rng0, low)
            rng = jnp.where(act, jnp.where(one, r1, rng0), rng)
            refill = act & (rng < 0x100)
            low = jnp.where(refill, (low << 8) | byte_at(pos, refill), low)
            rng = jnp.where(refill, rng << 8, rng)
            pos = jnp.where(refill, pos + 1, pos)
            bit = one.astype(jnp.int32)
            w0, w1 = _set_sub(w0, w1, slot, next_ref[sub * 2 + bit], act)

            zf = act & (phase == _ZF)
            ex = act & (phase == _EXP)
            ma = act & (phase == _MANT)
            sg = act & (phase == _SIGN)
            e2 = jnp.where(ex & one, e + 1, e)
            bad = ex & (e2 > 31)                    # `llcomp.hpp:232-234`
            err = err | bad
            value = jnp.where(zf, 0, value)
            value = jnp.where(ex & ~one, 1, value)
            value = jnp.where(ma, 2 * value + bit, value)
            value = jnp.where(sg & one, -value, value)
            j2 = jnp.where(ma, j + 1, j)
            nxt = phase
            nxt = jnp.where(zf, jnp.where(one, _DONE, _EXP), nxt)
            nxt = jnp.where(ex & ~one, jnp.where(e2 > 0, _MANT, _SIGN), nxt)
            nxt = jnp.where(bad, _DONE, nxt)
            nxt = jnp.where(ma & (j2 >= e2), _SIGN, nxt)
            nxt = jnp.where(sg, _DONE, nxt)
            return (w0, w1, low, rng, pos, nxt, value, e2, j2, err)

        c = (w0, w1, low, rng, pos, jnp.full((LANES,), _ZF, jnp.int32),
             zero, zero, zero, err)
        c = jax.lax.while_loop(
            lambda c: jnp.max(jnp.where(c[5] != _DONE, 1, 0)) > 0,
            decision, c)
        w0, w1, low, rng, pos, _, value, _, _, err = c
        m_ref[lane, 2 * hsh] = w0
        m_ref[lane, 2 * hsh + 1] = w1
        recon = pred + jnp.where(neg, -value, value)
        out_ref[k, lane] = recon
        return low, rng, pos, err, (recon,) + hist[:-1]

    low0 = (byte_at(zero, lane >= 0) << 8) | byte_at(zero + 1, lane >= 0)
    st = (low0, jnp.full((LANES,), 0xFF00, jnp.int32),
          jnp.full((LANES,), 2, jnp.int32), zero, (zero,) * hist_n)
    _, _, _, err, _ = jax.lax.fori_loop(0, n_sym, symbol, st)
    err_ref[lane] = err


@functools.partial(jax.jit,
                   static_argnames=("H", "W", "C", "cfg", "interpret"))
def decode_device(data, row, H: int, W: int, C: int,
                  cfg: CodecConfig = REV2, interpret: bool = False):
    """Decode lanes on the device.

    data u8 [S, cap] (zero-padded streams), row int32 (``model_row``) ->
    (images u8 [S, H, W, C], err bool [S])."""
    S = data.shape[0]
    data = _pad_lanes(data, S)
    Sp = data.shape[0]
    model = jnp.broadcast_to(row[None, :], (Sp, row.shape[0]))
    kernel = functools.partial(_decode_kernel, H=H, W=W, C=C, cfg=cfg)
    _, planes, err = pl.pallas_call(
        kernel,
        grid=(Sp // LANES,),
        out_shape=(
            jax.ShapeDtypeStruct(model.shape, jnp.int32),
            jax.ShapeDtypeStruct((H * W * C, Sp), jnp.int32),
            jax.ShapeDtypeStruct((Sp,), jnp.int32),
        ),
        input_output_aliases={3: 0},
        interpret=interpret,
        backend="triton",
        compiler_params=_params(),
        name="llcomp_decode",
    )(transform.STATE_PROB, transform.NEXT_STATE, data, model)
    planes = planes[:, :S].T.reshape(S, H, W, C)
    return transform.rct_inverse(planes), err[:S] != 0
