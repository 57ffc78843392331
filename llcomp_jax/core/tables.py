"""Rev-2 format tables as NumPy arrays.

These are *format data*, not code: the values define the llcomp rev-2 bitstream
and must match `/root/reference/llcomp.hpp:252-333` exactly for bit-exactness.
Where a table has regular structure (the MPS ladder, the quantizer bands) it is
generated; the irregular LPS fallback and probability tables are spelled out.
All tables are validated against independently-recorded literals in
``tests/test_tables.py``.
"""
from __future__ import annotations

import numpy as np


def _mps_table() -> np.ndarray:
    """MPS transition: climb two states, saturating at 126 (even) / 127 (odd).

    Matches ``nextStateMps`` at `llcomp.hpp:252-259` (tail ...125,126,127,126,127).
    """
    i = np.arange(128)
    return np.minimum(i + 2, 126 | (i & 1)).astype(np.uint8)


# LPS fallback transitions toward the 50/50 start states (`llcomp.hpp:261-268`).
NEXT_STATE_LPS = np.array([
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 18, 19, 22, 23, 22, 23, 24, 25, 26, 27, 26, 27, 30, 31, 30, 31,
    32, 33, 32, 33, 36, 37, 36, 37, 38, 39, 38, 39, 42, 43, 42, 43, 44, 45,
    44, 45, 46, 47, 48, 49, 48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55,
    56, 57, 58, 59, 58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65,
    66, 67, 66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
    72, 73, 72, 73, 74, 75, 76, 77, 76, 77, 76, 77, 76, 77, 78, 79,
], dtype=np.uint8)

NEXT_STATE_MPS = _mps_table()

# P(bit == 1 | state) scaled by 256 (`llcomp.hpp:270-281`).  Values span [7, 247],
# which keeps the range coder's sub-range strictly inside (0, range).
STATE_PROB = np.array([
    123, 131, 117, 137, 111, 143, 106, 148, 101, 153, 96, 158, 91, 163, 87, 167,
    83, 171, 79, 175, 75, 179, 72, 182, 68, 186, 66, 188, 63, 191, 60, 194,
    57, 197, 54, 200, 52, 202, 49, 205, 48, 206, 45, 209, 43, 211, 41, 213,
    40, 214, 38, 216, 36, 218, 35, 219, 33, 221, 32, 222, 30, 224, 30, 224,
    28, 226, 27, 227, 26, 228, 25, 229, 24, 230, 23, 231, 22, 232, 21, 233,
    21, 233, 20, 234, 19, 235, 18, 236, 18, 236, 17, 237, 17, 237, 16, 238,
    16, 238, 15, 239, 15, 239, 14, 240, 14, 240, 13, 241, 13, 241, 13, 241,
    12, 242, 12, 242, 12, 242, 11, 243, 11, 243, 11, 243, 11, 243, 7, 247,
], dtype=np.uint8)


def _quant_table(thresholds: tuple[int, ...]) -> np.ndarray:
    """Symmetric banded quantizer over two's-complement byte indices.

    Index k encodes the clamped signed difference d = k if k < 128 else k - 256;
    the output is sign(d) * (number of thresholds <= |d|).  With thresholds
    (1, 4) this reproduces ``quant5_table`` and with (1, 2, 5, 12, 35)
    ``quant11_table`` (`llcomp.hpp:297-333`).
    """
    k = np.arange(256)
    d = np.where(k < 128, k, k - 256)
    mag = np.searchsorted(np.asarray(thresholds), np.abs(d), side="right")
    return (np.sign(d) * mag).astype(np.int32)


QUANT5 = _quant_table((1, 4))
QUANT11 = _quant_table((1, 2, 5, 12, 35))

# Fused per-(state, bit) transition: NEXT_STATE[state * 2 + bit].  A bit equal to
# the state's MPS (its low bit, `llcomp.hpp:285`) climbs the MPS ladder,
# otherwise falls back via LPS.
_i = np.arange(128)
NEXT_STATE = np.empty(256, dtype=np.uint8)
NEXT_STATE[_i * 2 + (_i & 1)] = NEXT_STATE_MPS
NEXT_STATE[_i * 2 + 1 - (_i & 1)] = NEXT_STATE_LPS
del _i


# Sliced-container model prior ("primed" mode, container flag bit 0).
# The reference format has no sliced mode, so stripe model restarts are this
# framework's own problem.  The prior is HASH-BUCKETED: the context row of
# hash h starts at PRIOR_TAB[h % 121] — the bucket index is the hash's two
# low quantizer components q11(l-tl) + 11*q11(tl-t), i.e. how locally busy
# the neighborhood is.  Measured on the bench corpus at 8-row stripes this
# recovers ~94% of the stripe-restart ratio loss (1.892 cold -> 2.186
# bucketed vs 2.075 for a single constant row and 2.199 unsliced) for zero
# stored bytes (derivation + measurements: tools/derive_prior.py and
# tools/eval_bucketed_prior.py).  Substate k of a row: 0 = zero-flag, 1-4 =
# exponent unary, 5-6 = mantissa, 7 = sign.  FORMAT CONSTANTS of primed
# sliced containers: encoder and decoder must agree forever; never
# regenerate in place.
PRIOR_TAB = np.frombuffer(bytes.fromhex(
    "06070c122c1208061e01282e56160e0b300f102e620e0e215a37130a480804257e71"
    "3915180602417e7f7f7f7e011d7f01010101010101015a3d2511140a02324021070e"
    "3c0c061832111234520e101a1e01263456140e0c22032436541210181e01242c5616"
    "0c022a0b0c2456100a0f543311084608061d7e6b3915180802370101010101010101"
    "01010101010101016a4b2d1316080228482909103c0a060c34130c325a0e0c103011"
    "1234560e102034131032560e0e282a0b0e24560e0a103417001c4e0e08015231110a"
    "420a040f765f33131c0602257e7f017f0101117f7e7f7f270108027e7e5f35111a08"
    "022c5a3b15084008040a4e2d0b10420a060e4a2b0b0a3c0a061c4c2d0f08400a0424"
    "4a2b0d083c0a041c4a2b0d083a0a061056371502320a040076552d0d200804130101"
    "0101010101017e7f7f550206027e7e77411d120802347e6337111c06022c7e633515"
    "180802347e573b171606023c7e633915140604407e5b33151806023a765731131808"
    "022a76552f0f1e0a021676552b0b2608040001010101010101017e7f7f15030b0e7e"
    "7e7f7f3d020a02767e7f7745060a017e7e4f7f7f00150a7e7e7f7f7f0e01087e0101"
    "01010101010101010101010101010101010101010101010101010101010101010101"
    "01010101010101010101010101010101010101010101010101010101010101010101"
    "01010101010101010101010101010101010101010101010101010101010101010101"
    "010101010101010101010101010101017e7f7f7e017e7f7f01010101010101010101"
    "01010101010154311f06380a0a044c2d11003008040d623517002606061b623d1705"
    "2608042576472307220a042f70432107220a0427764925092408021f70532b092408"
    "04157e633913180602217e7f6b57040c0c7f01010101010101015631150120080414"
    "3a1b01102e0c0802381b001a3c0c081142230318480a061d46290914540a06214425"
    "09104a0c08174629090e480a060b5a3715084008060b765f350f1c0802297e7f7f6b"
    "0208087f010101010101010162391f09180804283a1b0112320c0610321306244c0c"
    "0a012e0f082c56100a092e0f0c2a5a0e0a152a0b0e2852100a0d2e0f0a225a0e0a09"
    "54310f0c460a06157e5f37131c0602357e7f7f45040e1a7f01010101010101015a41"
    "210b140804383c1f030e360c061a2e110a24520e0a0a22051a2c5a120e062001222e"
    "56160e071e01222c44160c022a0b142c520e0c175635110c480a06217e7139151a08"
    "02397e7f7f7f0e01097f01010101010101015a472311120606364223070c340a0624"
    "36150c2c520e0e1e260520365610101a"
), dtype=np.uint8).reshape(121, 8).copy()
PRIOR_BUCKETS = 121

# Previous single-row constant, kept as the derivation fallback for buckets
# with no training evidence (tools/derive_prior.py).
PRIOR_SUB = np.array([66, 41, 13, 6, 42, 10, 6, 6], dtype=np.uint8)


def prior_full(num_states: int, substates: int = 8) -> np.ndarray:
    """Flat per-cidx initial-state map [num_states] for primed mode."""
    nh = num_states // substates
    return np.ascontiguousarray(
        PRIOR_TAB[np.arange(nh) % PRIOR_BUCKETS]
    ).reshape(-1)


def prior_full_from(tab: np.ndarray, num_states: int,
                    substates: int = 8) -> np.ndarray:
    """Flat per-cidx initial-state map from an arbitrary [B, substates]
    bucket table (stored-seed containers, flag bit 1): context row h
    starts at tab[h % B], exactly like prior_full with PRIOR_TAB."""
    tab = np.asarray(tab, dtype=np.uint8)
    nh = num_states // substates
    return np.ascontiguousarray(
        tab[np.arange(nh) % tab.shape[0]]
    ).reshape(-1)


def quant5(x) -> np.ndarray:
    """quant5 with the reference's clamp-then-wrap indexing (`llcomp.hpp:339-341`)."""
    return QUANT5[np.clip(x, -128, 127) & 0xFF]


def quant11(x) -> np.ndarray:
    """quant11 with the reference's clamp-then-wrap indexing (`llcomp.hpp:335-337`)."""
    return QUANT11[np.clip(x, -128, 127) & 0xFF]
