"""NumPy-oracle conformance: golden vectors, round-trips, reference byte equality."""
import numpy as np
import pytest

from llcomp_jax import oracle
from tests.conftest import make_noise, make_photo

# Golden vectors: exact bytes emitted by the unmodified reference encoder
# (recorded in SURVEY.md §4 and re-verified against a fresh reference build).
GOLDEN = [
    (
        np.array([[[10, 20, 30]]], dtype=np.uint8),
        bytes.fromhex("790301000100" "8374be4365c6"),
    ),
    (
        np.array(
            [[[0, 0, 0], [255, 255, 255]], [[128, 64, 32], [1, 2, 3]]],
            dtype=np.uint8,
        ),
        bytes.fromhex("790302000200" "8369acbe11430f72fa279a75645a50140baf6c"),
    ),
    (
        # 4x4x3, pixel v = ((y*4+x)*5 + ch*7) & 255
        (
            (np.arange(16).reshape(4, 4, 1) * 5 + np.arange(3).reshape(1, 1, 3) * 7)
            & 255
        ).astype(np.uint8),
        bytes.fromhex(
            "790304000400"
            "83718988fd34d42ae2ccde39208b9da2c7a1c519a69cd6"
        ),
    ),
    (
        # 2x2x4 RGBA, values 10..160 step 10
        (np.arange(10, 170, 10, dtype=np.uint8).reshape(2, 2, 4)),
        bytes.fromhex("790402000200" "8374be4365c7c38b0c220af3fbe4933b1e3b06"),
    ),
]


@pytest.mark.parametrize("img,expect", GOLDEN, ids=["1x1", "2x2", "4x4", "2x2rgba"])
def test_golden_encode(img, expect):
    assert oracle.encode(img) == expect


@pytest.mark.parametrize("img,expect", GOLDEN, ids=["1x1", "2x2", "4x4", "2x2rgba"])
def test_golden_decode(img, expect):
    out = oracle.decode(expect)
    np.testing.assert_array_equal(out, img)


def test_golden_checkerboard():
    yy, xx = np.mgrid[0:8, 0:8]
    img = (((yy + xx) % 2) * 255).astype(np.uint8)[..., None].repeat(3, axis=-1)
    data = oracle.encode(img)
    assert len(data) == 97
    assert data[:7] == bytes.fromhex("79030800080083")
    np.testing.assert_array_equal(oracle.decode(data), img)


def test_single_row_col_symmetry():
    """Boundary fallbacks make 3x1 and 1x3 emit the same payload (SURVEY §4)."""
    px = np.array([[100, 110, 120], [101, 111, 121], [103, 112, 125]], np.uint8)
    row = oracle.encode(px.reshape(1, 3, 3))
    col = oracle.encode(px.reshape(3, 1, 3))
    assert row[6:] == col[6:]
    assert row[6:] == bytes.fromhex("8374bb23f9ed72ea")


@pytest.mark.parametrize(
    "shape", [(1, 1, 3), (2, 2, 3), (4, 4, 3), (1, 3, 3), (3, 1, 3), (16, 16, 3),
              (7, 5, 3), (8, 8, 4), (5, 3, 1), (6, 4, 2)]
)
def test_roundtrip_shapes(shape):
    img = make_photo(*shape, seed=shape[0] * 100 + shape[1])
    np.testing.assert_array_equal(oracle.decode(oracle.encode(img)), img)


def test_roundtrip_noise():
    """Incompressible input crashes the reference; we must handle it."""
    img = make_noise(16, 16)
    data = oracle.encode(img)
    assert len(data) > 16 * 16 * 3  # expansion, not overflow
    np.testing.assert_array_equal(oracle.decode(data), img)


def test_roundtrip_flat():
    img = np.full((32, 32, 3), 77, dtype=np.uint8)
    data = oracle.encode(img)
    assert len(data) < 100  # ~153x compression on flat input
    np.testing.assert_array_equal(oracle.decode(data), img)


def test_roundtrip_grayscale():
    """c<3 decode is broken in the reference; ours must be correct (SURVEY §2.8)."""
    img = make_photo(12, 9, c=1)
    np.testing.assert_array_equal(oracle.decode(oracle.encode(img)), img)


def test_vs_reference_binary(ref_oracle):
    for img in [
        make_photo(32, 24),
        make_photo(17, 13, seed=7),
        make_photo(8, 8, c=4),
        np.full((16, 16, 3), 200, np.uint8),
    ]:
        ref_bytes = ref_oracle.encode(img)
        assert oracle.encode(img) == ref_bytes
        np.testing.assert_array_equal(oracle.decode(ref_bytes), img)
        np.testing.assert_array_equal(
            ref_oracle.decode(oracle.encode(img), img.shape), img
        )


def test_binarize_matches_scalar_spec():
    rng = np.random.default_rng(3)
    vals = np.concatenate(
        [np.array([0, 1, -1, 2, -2, 3, 127, -128, 255, -255, 1274, -1274]),
         rng.integers(-1274, 1275, size=200)]
    )
    ctx, bit, valid = oracle.binarize(vals)

    def scalar_bins(v):
        out = []
        uv = abs(int(v))
        if uv == 0:
            return [(0, 1)]
        e = uv.bit_length() - 1
        out.append((0, 0))
        c = 1
        for _ in range(e):
            out.append((min(c, 4), 1))
            c += 1
        out.append((min(c, 4), 0))
        c = 5
        for i in range(e - 1, -1, -1):
            out.append((min(c, 6), (uv >> i) & 1))
            c += 1
        out.append((7, 1 if v < 0 else 0))
        return out

    for si, v in enumerate(vals):
        expect = scalar_bins(v)
        got = [(int(ctx[si, k]), int(bit[si, k])) for k in range(24) if valid[si, k]]
        assert got == expect, f"symbol {v}"
