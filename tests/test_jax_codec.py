"""JAX lane-parallel encoder/decoder vs the NumPy oracle (and golden bytes)."""
import numpy as np
import pytest

from llcomp_jax import decode as jdec
from llcomp_jax import encode as jenc
from llcomp_jax import oracle
from tests.conftest import make_noise, make_photo


@pytest.mark.parametrize(
    "shape",
    [(1, 1, 3), (2, 2, 3), (4, 4, 3), (16, 16, 3), (7, 5, 3), (8, 8, 4),
     (5, 3, 1), (6, 4, 2), (1, 8, 3), (8, 1, 3)],
)
def test_encode_matches_oracle(shape):
    img = make_photo(*shape, seed=sum(shape))
    assert jenc.encode_lanes(img[None])[0] == oracle.encode(img)[6:]


def test_encode_batch_lockstep():
    lanes = np.stack(
        [make_photo(8, 16, seed=i) for i in range(3)] + [make_noise(8, 16)]
    )
    outs = jenc.encode_lanes(lanes)
    for i in range(4):
        assert outs[i] == oracle.encode(lanes[i])[6:]


@pytest.mark.parametrize(
    "shape", [(1, 1, 3), (4, 4, 3), (16, 16, 3), (7, 5, 3), (8, 8, 4), (5, 3, 1)]
)
def test_decode_matches_oracle(shape):
    img = make_photo(*shape, seed=sum(shape) * 3)
    blob = oracle.encode(img)
    out = jdec.decode_lanes([blob[6:]], shape)
    np.testing.assert_array_equal(out[0], img)


def test_decode_batch_mixed_content():
    lanes = [make_photo(8, 16, seed=i) for i in range(3)] + [
        make_noise(8, 16),
        np.full((8, 16, 3), 42, np.uint8),
    ]
    streams = [oracle.encode(l)[6:] for l in lanes]
    outs = jdec.decode_lanes(streams, (8, 16, 3))
    for i, l in enumerate(lanes):
        np.testing.assert_array_equal(outs[i], l)


def test_jax_roundtrip_jax_only():
    """encode_lanes -> decode_lanes without touching the oracle."""
    lanes = np.stack([make_photo(12, 12, seed=s) for s in range(6)])
    streams = jenc.encode_lanes(lanes)
    outs = jdec.decode_lanes(streams, (12, 12, 3))
    np.testing.assert_array_equal(outs, lanes)


def test_decode_corrupt_stream_flags_error():
    """Corrupt bytes either raise, or decode to a valid self-consistent image.

    Arithmetic coders accept most byte soups as *some* symbol sequence, so
    random corruption rarely trips the e>31 / 24-decision guards on tiny
    images (the raise path is pinned by test_decode_malicious_exponent_raises
    below).  What must always hold: decode never hangs and never emits
    garbage that is not itself a well-formed image — i.e. whatever it decodes
    re-encodes and decodes back to the identical pixels.
    """
    img = make_photo(8, 8)
    base = bytearray(oracle.encode(img)[6:])
    for seed in range(4):
        rng = np.random.default_rng(seed)
        blob = bytearray(base)
        blob[2:] = bytes(
            rng.integers(0, 256, len(blob) - 2, dtype=np.uint8).tolist()
        )
        try:
            out = jdec.decode_lanes([bytes(blob)], (8, 8, 3))
        except ValueError as e:
            assert "corrupt" in str(e)
            continue
        assert out.shape == (1, 8, 8, 3) and out.dtype == np.uint8
        restream = jenc.encode_lanes(out)
        again = jdec.decode_lanes(restream, (8, 8, 3))
        np.testing.assert_array_equal(again, out)


def test_encode_vs_reference_binary(ref_oracle):
    img = make_photo(24, 32, seed=11)
    assert jenc.encode_lanes(img[None])[0] == ref_oracle.encode(img)[6:]


def test_decode_reference_stream(ref_oracle):
    img = make_photo(24, 32, seed=12)
    blob = ref_oracle.encode(img)
    out = jdec.decode_lanes([blob[6:]], img.shape)
    np.testing.assert_array_equal(out[0], img)


def test_decode_engines_agree():
    """The XLA decision-outer engine and the GPU kernel (interpreted)
    produce identical output."""
    lanes = [make_photo(8, 16, seed=50 + i) for i in range(3)] + [
        make_noise(8, 16, seed=1), np.full((8, 16, 3), 9, np.uint8)
    ]
    streams = [oracle.encode(l)[6:] for l in lanes]
    a = jdec.decode_lanes(streams, (8, 16, 3), engine="decision")
    b = jdec.decode_lanes(streams, (8, 16, 3), engine="gpu", interpret=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, np.stack(lanes))


def test_decode_malicious_exponent_raises():
    """A stream coding >31 exponent ones must raise, like the reference."""
    from tests.test_native import _malicious_stream

    for engine in ("decision", "gpu"):
        with pytest.raises(ValueError):
            jdec.decode_lanes([_malicious_stream()], (4, 4, 3), engine=engine,
                              interpret=engine == "gpu")


def test_encode_pipelines_agree():
    """Model-free XLA engine (sort + segmented walk) vs the GPU kernel,
    which carries each lane's model through the walk: identical bytes,
    plain and primed."""
    lanes = np.stack(
        [make_photo(8, 16, seed=70 + i) for i in range(2)] + [make_noise(8, 16)]
    )
    for primed in (False, True):
        a = jenc.encode_lanes(lanes, engine="xla", primed=primed)
        b = jenc.encode_lanes(lanes, engine="gpu", primed=primed,
                              interpret=True)
        assert a == b
