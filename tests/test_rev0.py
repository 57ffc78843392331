"""Revision-0 (llcomp.js) codec: round-trips, dispatch, divergence from rev 2.

No Node runtime exists in this environment, so rev-0 conformance is
established by round-trip plus structural checks (shared components are
covered by the rev-2 golden tests; the rev-0-specific tables/floats are
transcribed from llcomp.js and spot-asserted here).
"""
import numpy as np
import pytest

import llcomp_jax
from llcomp_jax import oracle, rev0
from tests.conftest import make_noise, make_photo


@pytest.mark.parametrize(
    "shape", [(1, 1, 3), (2, 2, 3), (8, 8, 3), (7, 5, 3), (6, 6, 4), (16, 16, 3)]
)
def test_rev0_roundtrip(shape):
    img = make_photo(*shape, seed=sum(shape))
    np.testing.assert_array_equal(rev0.decode(rev0.encode(img)), img)


def test_rev0_roundtrip_noise_and_flat():
    for img in [make_noise(12, 12), np.full((16, 16, 3), 200, np.uint8)]:
        np.testing.assert_array_equal(rev0.decode(rev0.encode(img)), img)


def test_rev0_magic_and_divergence():
    img = make_photo(8, 8)
    b0 = rev0.encode(img)
    b2 = oracle.encode(img)
    assert b0[0] == 0x77 and b2[0] == 0x79
    assert b0[1:6] == b2[1:6]      # same header layout
    assert b0[6:] != b2[6:]        # different entropy coding


def test_rev0_channel_restriction():
    with pytest.raises(ValueError):
        rev0.encode(make_photo(4, 4, c=1))


def test_rev0_tables_spot():
    # llcomp.js:95-111 tails
    assert list(rev0.NEXT_STATE_MPS_0[-6:]) == [124, 125, 124, 125, 126, 127]
    assert list(rev0.NEXT_STATE_LPS_0[-4:]) == [76, 77, 126, 127]
    assert rev0.MPS_PROBABILITY[0] == 0.5156 and rev0.MPS_PROBABILITY[63] == 0.9702
    assert len(rev0.MPS_PROBABILITY) == 64


# Golden byte vectors, pinned as regression locks.  No JS runtime exists in
# this environment (node/deno/quickjs all absent), so these are derived from
# rev0.py itself and locked; the semantics they encode are derived
# decision-by-decision from llcomp.js (see test_rev0_coder_trace below, which
# pins the first two coder decisions to hand-computed values).  If a Node
# runtime ever becomes available, `node /root/reference/llcomp.js` output for
# these images must byte-match.
GOLDEN_REV0 = {
    (1, 1, 3): "7703010001008266d6e11f3a",
    (2, 2, 3): "770302000200825ba6a4f74bfbffafc811a6b0307247632a91",
    (4, 4, 3): "7703040004008261c3981a766b9810e7cdda4d55c2bfbbf453ed46ac50c1720d16",
    (2, 2, 4): "7704020002008266d6e11f3b221ec719257457c884bd6a7127",
}


def _golden_image(shape):
    H, W, C = shape
    if shape == (1, 1, 3):
        return np.array([[[10, 20, 30]]], np.uint8)
    if shape == (2, 2, 3):
        return np.array(
            [[[0, 0, 0], [255, 255, 255]], [[128, 64, 32], [1, 2, 3]]], np.uint8
        )
    if shape == (4, 4, 3):
        return (np.arange(48).reshape(4, 4, 3) * 5 % 256).astype(np.uint8)
    return np.arange(10, 170, 10, dtype=np.uint8).reshape(2, 2, 4)


@pytest.mark.parametrize("shape", sorted(GOLDEN_REV0))
def test_rev0_golden_bytes(shape):
    img = _golden_image(shape)
    blob = rev0.encode(img)
    assert blob.hex() == GOLDEN_REV0[shape]
    np.testing.assert_array_equal(rev0.decode(bytes.fromhex(GOLDEN_REV0[shape])), img)


def test_rev0_coder_trace():
    """Pin the first two coder decisions of the 1x1x3 golden to hand-derived
    values from the llcomp.js:39-52 clamped-float split.

    Image (10,20,30); RCT (llcomp.js:343-346) gives coded (r',g',b') =
    (-10, 20, 10).  First symbol: all neighbors fall back to the seed 128
    (llcomp.js:317-329), hash = 0, predict = 128, diff = -10-128 = -138,
    no sign fold.  putSymbol starts with the zero-flag bit 0 at ctx 0.
    State 0 is even => MPS = 0, P(MPS) = MPS_PROBABILITY[0] = 0.5156
    (llcomp.js:113), so the coded P(bit==1) = 0.4844.

    decision 1 (bit 0): range1 = int(0xFF00 * 0.4844) = 31621, clamp is a
      no-op; bit 0 takes range = 65280 - 31621 = 33659, low stays 0.
    decision 2 (first exponent bit, 1, at ctx 1, also state 0):
      range1 = int(33659 * 0.4844) = 16304; bit 1 adds 33659 - 16304 =
      17355 to low and sets range = 16304.
    """
    enc = rev0.RangeEncoder0()
    enc.put(0, 1 - 0.5156)
    assert (enc.low, enc.range) == (0, 33659)
    enc.put(1, 1 - 0.5156)
    assert (enc.low, enc.range) == (17355, 16304)


def test_api_dispatch():
    img = make_photo(8, 8)
    blob = llcomp_jax.compress(img, revision=0)
    assert blob[0] == 0x77
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)
    with pytest.raises(ValueError):
        llcomp_jax.compress(img, revision=1)


def test_rev0_cross_rejects():
    """rev-0 decoder rejects rev-2 streams and vice versa."""
    img = make_photo(8, 8)
    with pytest.raises(ValueError):
        rev0.decode(oracle.encode(img))
    with pytest.raises(ValueError):
        oracle.decode(rev0.encode(img))
