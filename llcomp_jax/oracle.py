"""Pure-NumPy oracle implementation of the llcomp rev-2 codec.

This is the executable specification: a from-scratch reimplementation of the
bitstream defined by `/root/reference/llcomp.hpp` (see SURVEY.md for the full
semantic analysis), organized the way the device pipeline is organized —

  1. whole-image vectorized precompute (color transform, neighbor fetch,
     context hash, prediction, residual, sign folding, binarization); and
  2. a strictly sequential entropy-coding loop (the only part of the format
     that is inherently serial per stream).

Every stage doubles as the unit-test oracle for the corresponding JAX/Pallas
stage.  It intentionally fixes two reference bugs without changing any emitted
byte for inputs the reference handles (SURVEY.md §2.8-2.9): output is grown
dynamically (no compressed-larger-than-raw overflow) and the inverse color
transform is guarded on channels >= 3 (grayscale decodes correctly).
"""
from __future__ import annotations

import numpy as np

from .core import tables
from .core.config import REV2, CodecConfig

# ---------------------------------------------------------------------------
# Stage 1a: reversible color transform  (`llcomp.hpp:396-409`, inverse 532-540)
# ---------------------------------------------------------------------------


def _trunc_div4(x: np.ndarray) -> np.ndarray:
    """C++ integer division by 4 truncates toward zero; numpy // floors."""
    x = np.asarray(x)
    return np.where(x >= 0, x // 4, -((-x) // 4))


def rct_forward(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] image -> int16 transformed planes.

    For C >= 3 the first three channels become (r-g, g + (b-g + r-g)/4, b-g);
    extra channels (alpha, ...) pass through.  For C < 3 all channels pass
    through.  Output ranges: r, b in [-255, 255], g in [-127, 382].
    """
    v = img.astype(np.int32).copy()
    if img.shape[-1] >= 3:
        r = v[..., 0] - v[..., 1]
        b = v[..., 2] - v[..., 1]
        g = v[..., 1] + _trunc_div4(b + r)
        v[..., 0], v[..., 1], v[..., 2] = r, g, b
    return v.astype(np.int16)


def rct_inverse(planes: np.ndarray) -> np.ndarray:
    """int16/int32 transformed planes -> uint8 image (clamped to [0, 255])."""
    v = planes.astype(np.int32).copy()
    if planes.shape[-1] >= 3:
        r, g, b = v[..., 0], v[..., 1], v[..., 2]
        g = g - _trunc_div4(r + b)
        r = r + g
        b = b + g
        v[..., 0], v[..., 1], v[..., 2] = r, g, b
        v[..., :3] = np.clip(v[..., :3], 0, 255)
    return v.astype(np.uint8)


# ---------------------------------------------------------------------------
# Stage 1b: neighbor extraction  (`llcomp.hpp:417-422`, decode mirror 494-499)
# ---------------------------------------------------------------------------


def neighbors(v: np.ndarray) -> dict[str, np.ndarray]:
    """Causal neighbors of every sample of int16 planes ``v`` [H, W, C].

    Boundary fallbacks follow the reference exactly: the very first pixel of a
    stream seeds ``l`` with 128; row 0 folds top neighbors onto ``l``; column
    boundaries fold onto ``l``/``t``.  Because encoding is lossless the encoder
    may read neighbors from the original transformed image — this is what makes
    the whole stage embarrassingly parallel.
    """
    x = v.astype(np.int32)
    H, W, _ = x.shape

    l = np.empty_like(x)
    l[:, 1:] = x[:, :-1]
    if H > 1:
        l[1:, 0] = x[:-1, 0]
    l[0, 0] = 128

    t = np.empty_like(x)
    t[1:] = x[:-1]
    t[0] = l[0]

    L = np.empty_like(x)
    if W > 2:
        L[:, 2:] = x[:, :-2]
    L[:, : min(2, W)] = l[:, : min(2, W)]

    tl = np.empty_like(x)
    tl[1:, 1:] = x[:-1, :-1]
    tl[0, :] = t[0, :]
    tl[:, 0] = t[:, 0]

    tr = np.empty_like(x)
    if W > 1:
        tr[1:, :-1] = x[:-1, 1:]
    tr[0, :] = t[0, :]
    tr[1:, W - 1] = t[1:, W - 1]

    T = np.empty_like(x)
    if H > 2:
        T[2:] = x[:-2]
    T[: min(2, H)] = t[: min(2, H)]

    return {"l": l, "t": t, "L": L, "tl": tl, "tr": tr, "T": T}


# ---------------------------------------------------------------------------
# Stage 1c: context hash + prediction + residual  (`llcomp.hpp:424-436`)
# ---------------------------------------------------------------------------


def median3(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Median of three == clip the gradient term into [min, max] of the others."""
    return np.clip(b, np.minimum(a, c), np.maximum(a, c))


def context_and_residual(
    v: np.ndarray, cfg: CodecConfig = REV2
) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample (folded context hash, folded residual) of planes ``v``.

    hash = q11(l-tl) + 11 q11(tl-t) + 121 q11(t-tr) [+ 605 q5(L-l) + 3025 q5(T-t)]
    predict = median(l, l + t - tl, t);  diff = v - predict;
    a negative hash negates both (halving the model, `llcomp.hpp:433-436`).
    """
    n = neighbors(v)
    l, t, L, tl, tr, T = n["l"], n["t"], n["L"], n["tl"], n["tr"], n["T"]
    h = (
        tables.quant11(l - tl)
        + tables.quant11(tl - t) * 11
        + tables.quant11(t - tr) * 121
    )
    if cfg.large_model:
        h = h + tables.quant5(L - l) * 605 + tables.quant5(T - t) * 3025
    predict = median3(l, l + t - tl, t)
    diff = v.astype(np.int32) - predict
    neg = h < 0
    return np.where(neg, -h, h), np.where(neg, -diff, diff)


# ---------------------------------------------------------------------------
# Stage 1d: binarization  (`llcomp.hpp:166-206` / decode mirror 219-247)
# ---------------------------------------------------------------------------


def binarize(diff: np.ndarray, cfg: CodecConfig = REV2):
    """Decompose signed residuals into fixed 24-slot binary-decision rows.

    Returns (ctx [N, 24] uint8, bit [N, 24] uint8, valid [N, 24] bool) where N
    is the flattened symbol count.  Slot layout per nonzero value v with
    e = floor(log2 |v|):

      slot 0                 zero flag     ctx 0,            bit 0
      slots 1 .. e           unary exp     ctx min(slot, 4), bit 1
      slot  e+1              exp stop      ctx min(e+1, 4),  bit 0
      slots e+2 .. 2e+1      mantissa MSB> ctx min(5+j, 6),  bit (|v|>>i)&1
      slot  2e+2             sign          ctx 7,            bit v<0

    and a zero value is the single slot (ctx 0, bit 1).  Max 2e+3 = 23 slots.
    """
    v = np.asarray(diff, dtype=np.int64).reshape(-1)
    n = v.shape[0]
    uv = np.abs(v)
    nz = uv != 0
    # exponent; 0 for v == 0 (unused there)
    e = np.zeros(n, dtype=np.int64)
    e[nz] = np.floor(np.log2(uv[nz].astype(np.float64))).astype(np.int64)
    # floating log2 is exact for our magnitudes (< 2**20), but guard anyway:
    e[nz] = np.where(uv[nz] >> e[nz] >= 2, e[nz] + 1, e[nz])
    e[nz] = np.where(uv[nz] >> e[nz] == 0, e[nz] - 1, e[nz])

    K = cfg.max_bins_per_symbol
    s = np.arange(K)[None, :]                       # slot index grid [1, K]
    e2 = e[:, None]
    uv2 = uv[:, None]

    in_exp = (s >= 1) & (s <= e2)
    is_stop = s == e2 + 1
    in_mant = (s >= e2 + 2) & (s <= 2 * e2 + 1)
    is_sign = s == 2 * e2 + 2

    ctx = np.zeros((n, K), dtype=np.int64)
    bit = np.zeros((n, K), dtype=np.int64)
    valid = np.zeros((n, K), dtype=bool)

    # slot 0: zero flag
    valid[:, 0] = True
    bit[:, 0] = (~nz).astype(np.int64)

    ctx = np.where(in_exp, np.minimum(s, cfg.e_lim), ctx)
    bit = np.where(in_exp, 1, bit)
    ctx = np.where(is_stop, np.minimum(e2 + 1, cfg.e_lim), ctx)
    mant_shift = 2 * e2 + 1 - s                     # i = e-1 .. 0 across slots
    ctx = np.where(in_mant, np.minimum(cfg.e_lim + 1 + (s - e2 - 2), cfg.r_lim), ctx)
    bit = np.where(in_mant, (uv2 >> np.maximum(mant_shift, 0)) & 1, bit)
    ctx = np.where(is_sign, cfg.sign_ctx, ctx)
    bit = np.where(is_sign, (v < 0)[:, None].astype(np.int64), bit)

    nzmask = nz[:, None]
    valid = valid | (nzmask & (in_exp | is_stop | in_mant | is_sign))
    ctx = np.where(valid, ctx, 0)
    bit = np.where(valid, bit, 0)
    return ctx.astype(np.uint8), bit.astype(np.uint8), valid


# ---------------------------------------------------------------------------
# Stage 2: carry-less byte-wise range coder  (`llcomp.hpp:33-127`)
# ---------------------------------------------------------------------------


class RangeEncoder:
    """Scalar range encoder with lazy carry resolution.

    State: (low, range, pending byte, pending-0xFF run).  Each ``put`` shrinks
    ``range`` by the scaled probability and renormalizes at most once (range
    stays >= 1, so one byte shift restores range >= 0x100) — the bounded-work
    property the fixed-shape XLA scan relies on.
    """

    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFF00
        self.pending = -1      # "outstanding" byte awaiting carry resolution
        self.run = 0           # count of buffered 0xFF bytes after it
        self.out = bytearray()

    def _shift(self) -> None:
        if self.pending < 0:
            self.pending = self.low >> 8
        elif self.low <= 0xFF00:                    # no carry: flush pending + FF run
            self.out.append(self.pending & 0xFF)
            self.out.extend(b"\xff" * self.run)
            self.run = 0
            self.pending = self.low >> 8
        elif self.low >= 0x10000:                   # carry: pending+1 then 00 run
            self.out.append((self.pending + 1) & 0xFF)
            self.out.extend(b"\x00" * self.run)
            self.run = 0
            self.pending = (self.low >> 8) & 0xFF
        else:                                       # top byte is 0xFF: defer
            self.run += 1
        self.low = (self.low & 0xFF) << 8
        self.range <<= 8

    def put(self, bit: int, prob: int) -> None:
        range1 = (self.range * prob) >> 8
        if bit:
            self.low += self.range - range1
            self.range = range1
        else:
            self.range -= range1
        if self.range < 0x100:
            self._shift()

    def finish(self) -> bytes:
        """Two forced shifts flush the last payload bytes (`llcomp.hpp:75-81`).

        The byte left pending after the second shift is intentionally dropped;
        the decoder reads zeros past end-of-stream.
        """
        for _ in range(2):
            self.range = 0xFF
            self.low += 0xFF if _ == 0 else 0
            self._shift()
        return bytes(self.out)


class RangeDecoder:
    """Scalar range decoder; reads zeros past end-of-buffer (`llcomp.hpp:475-479`)."""

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.range = 0xFF00
        self.low = (self._byte() << 8) | self._byte()

    def _byte(self) -> int:
        if self.pos >= len(self.data):
            return 0
        b = self.data[self.pos]
        self.pos += 1
        return b

    def get(self, prob: int) -> int:
        range1 = (self.range * prob) >> 8
        self.range -= range1
        if self.low < self.range:
            bit = 0
        else:
            self.low -= self.range
            self.range = range1
            bit = 1
        if self.range < 0x100:
            self.range <<= 8
            self.low = (self.low << 8) | self._byte()
        return bit


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _header(width: int, height: int, channels: int, cfg: CodecConfig) -> bytes:
    return bytes(
        [cfg.magic, channels, width & 0xFF, (width >> 8) & 0xFF,
         height & 0xFF, (height >> 8) & 0xFF]
    )


def prior_states(cfg: CodecConfig = REV2) -> np.ndarray:
    """Primed-mode initial model: context row h starts at PRIOR_TAB[h % 121].

    Used by sliced containers with flag bit 0 set (hash-bucketed prior,
    tables.PRIOR_TAB); the reference-compatible single-stream format always
    starts from zeros.
    """
    return tables.prior_full(cfg.num_states, cfg.substates)


def encode_planes(v: np.ndarray, cfg: CodecConfig = REV2,
                  primed: bool = False, seed=None) -> bytes:
    """Entropy-code already-transformed int16 planes into a headerless stream.

    seed: optional [121, 8] u8 stored-seed table (container flag bit 1)
    replacing the static prior values (context row h starts at
    seed[h % 121])."""
    hash_, diff = context_and_residual(v, cfg)
    ctx, bit, valid = binarize(diff, cfg)
    sym_hash = hash_.reshape(-1)

    if seed is not None:
        states = tables.prior_full_from(seed, cfg.num_states,
                                        cfg.substates).copy()
    elif primed:
        states = prior_states(cfg)
    else:
        states = np.zeros(cfg.num_states, dtype=np.uint8)
    prob = tables.STATE_PROB
    nxt = tables.NEXT_STATE
    enc = RangeEncoder()
    K = cfg.max_bins_per_symbol
    for si in range(ctx.shape[0]):
        base = int(sym_hash[si]) * cfg.substates
        for k in range(K):
            if not valid[si, k]:
                break
            idx = base + int(ctx[si, k])
            st = states[idx]
            b = int(bit[si, k])
            enc.put(b, int(prob[st]))
            states[idx] = nxt[st * 2 + b]
    return enc.finish()


def encode(img: np.ndarray, cfg: CodecConfig = REV2) -> bytes:
    """uint8 [H, W, C] -> reference-compatible .llcomp byte stream."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    return _header(W, H, C, cfg) + encode_planes(rct_forward(img), cfg)


def decode(data: bytes, cfg: CodecConfig = REV2) -> np.ndarray:
    """Reference-compatible .llcomp byte stream -> uint8 [H, W, C] image."""
    if data[0] != cfg.magic:
        raise ValueError("Invalid magic number")
    C = data[1]
    W = data[2] | (data[3] << 8)
    H = data[4] | (data[5] << 8)
    dec = RangeDecoder(data, pos=6)

    states = np.zeros(cfg.num_states, dtype=np.uint8)
    prob = tables.STATE_PROB
    nxt = tables.NEXT_STATE
    q11 = tables.QUANT11
    q5 = tables.QUANT5
    e_lim, r_lim, s_ctx = cfg.e_lim, cfg.r_lim, cfg.sign_ctx

    lines = np.zeros((3, W * C), dtype=np.int64)
    out = np.empty((H, W, C), dtype=np.uint8)

    def q(table, x):
        return int(table[max(-128, min(127, x)) & 0xFF])

    for h in range(H):
        line0 = lines[h % 3]
        line1 = lines[(h + 2) % 3]
        line2 = lines[(h + 1) % 3]
        for w in range(W):
            x = w * C
            for i in range(C):
                l = int(line0[x - C + i]) if w > 0 else (int(line1[x + i]) if h > 0 else 128)
                t = int(line1[x + i]) if h > 0 else l
                L = int(line0[x - 2 * C + i]) if w > 1 else l
                tl = int(line1[x - C + i]) if h > 0 and w > 0 else t
                tr = int(line1[x + C + i]) if h > 0 and w < W - 1 else t
                T = int(line2[x + i]) if h > 1 else t

                hsh = q(q11, l - tl) + q(q11, tl - t) * 11 + q(q11, t - tr) * 121
                if cfg.large_model:
                    hsh += q(q5, L - l) * 605 + q(q5, T - t) * 3025
                predict = median3(l, l + t - tl, t)
                neg = hsh < 0
                if neg:
                    hsh = -hsh
                base = hsh * cfg.substates

                def rac(ctx: int) -> int:
                    idx = base + ctx
                    st = states[idx]
                    b = dec.get(int(prob[st]))
                    states[idx] = nxt[st * 2 + b]
                    return b

                # getSymbol mirror (`llcomp.hpp:219-247`)
                if rac(0):
                    diff = 0
                else:
                    e = 0
                    c = 1
                    while rac(min(c, e_lim)):
                        c += 1
                        e += 1
                        if e > 31:
                            raise ValueError("Invalid exponent")
                    value = 1
                    c = e_lim + 1
                    for _ in range(e):
                        value = 2 * value + rac(min(c, r_lim))
                        c += 1
                    diff = -value if rac(s_ctx) else value
                if neg:
                    diff = -diff
                line0[x + i] = predict + diff

            if C >= 3:  # guard fixes the reference's broken c<3 decode (SURVEY §2.8)
                r, g, b = int(line0[x]), int(line0[x + 1]), int(line0[x + 2])
                g -= int(_trunc_div4(np.int64(r + b)))
                r += g
                b += g
                out[h, w, 0] = max(0, min(255, r))
                out[h, w, 1] = max(0, min(255, g))
                out[h, w, 2] = max(0, min(255, b))
                for i in range(3, C):
                    out[h, w, i] = line0[x + i] & 0xFF
            else:
                for i in range(C):
                    out[h, w, i] = max(0, min(255, int(line0[x + i])))
    return out
