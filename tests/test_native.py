"""Native C++ host runtime vs the oracle / golden vectors."""
import numpy as np
import pytest

from tests.conftest import make_noise, make_photo

pytest.importorskip("ctypes")


@pytest.fixture(scope="module")
def host():
    from llcomp_jax.native.build import NativeBuildError

    try:
        from llcomp_jax import host as h

        h.encode_stream(np.zeros((1, 1, 3), np.uint8))  # force build
        return h
    except NativeBuildError:
        pytest.skip("no C++ compiler on this host")


@pytest.mark.parametrize(
    "shape", [(1, 1, 3), (2, 2, 3), (4, 4, 3), (16, 16, 3), (7, 5, 3),
              (8, 8, 4), (5, 3, 1), (6, 4, 2), (1, 9, 3), (9, 1, 3)]
)
def test_native_encode_matches_oracle(host, shape):
    from llcomp_jax import oracle

    img = make_photo(*shape, seed=sum(shape) * 7)
    assert host.encode_stream(img) == oracle.encode(img)[6:]


def test_native_decode_roundtrip(host):
    imgs = [make_photo(16, 16), make_noise(8, 8), make_photo(9, 5, c=4),
            make_photo(6, 6, c=1), np.full((12, 12, 3), 7, np.uint8)]
    for img in imgs:
        blob = host.encode_stream(img)
        np.testing.assert_array_equal(host.decode_stream(blob, img.shape), img)


def test_native_golden(host):
    img = np.array([[[10, 20, 30]]], dtype=np.uint8)
    assert host.encode_stream(img) == bytes.fromhex("8374be4365c6")


def test_native_cross_decodes_jax_stream(host):
    from llcomp_jax import encode as jenc

    img = make_photo(12, 20, seed=5)
    blob = jenc.encode_lanes(img[None])[0]
    np.testing.assert_array_equal(host.decode_stream(blob, img.shape), img)


def _malicious_stream():
    """Arithmetic-code an unterminated unary exponent (> 31 ones)."""
    from llcomp_jax import oracle
    from llcomp_jax.core import tables

    enc = oracle.RangeEncoder()
    states = np.zeros(8, dtype=np.uint8)  # hash 0 contexts
    decisions = [(0, 0)] + [(min(k, 4), 1) for k in range(1, 40)]
    for ctx, bit in decisions:
        st = states[ctx]
        enc.put(bit, int(tables.STATE_PROB[st]))
        states[ctx] = tables.NEXT_STATE[st * 2 + bit]
    return enc.finish()


def test_native_corrupt_stream(host):
    with pytest.raises(ValueError):
        host.decode_stream(_malicious_stream(), (4, 4, 3))


def test_native_expand_slots_matches_python(host):
    from llcomp_jax import coder

    rng = np.random.default_rng(0)
    meta = (
        rng.integers(0, 2, 64) | (rng.integers(0, 2, 64) << 1)
        | (rng.integers(0, 256, 64) << 8)
    ).astype(np.int32)
    runs = rng.integers(0, 5, 64).astype(np.int32)
    assert host.expand_slots(meta, runs) == coder.expand_slots(meta, runs)


def test_native_backend_via_api(host):
    import llcomp_jax

    img = make_photo(10, 14)
    blob = llcomp_jax.compress(img, backend="native")
    assert blob == llcomp_jax.compress(img, backend="oracle")
    np.testing.assert_array_equal(
        llcomp_jax.decompress(blob, backend="native"), img
    )


def test_native_batch_decode(host):
    lanes = [make_photo(16, 16, seed=40 + i) for i in range(6)]
    streams = [host.encode_stream(l) for l in lanes]
    out = host.decode_streams(streams, (16, 16, 3), n_threads=3)
    np.testing.assert_array_equal(out, np.stack(lanes))


def test_native_batch_encode(host):
    lanes = np.stack([make_photo(12, 10, seed=50 + i) for i in range(5)])
    streams = host.encode_images(lanes, n_threads=2)
    from llcomp_jax import oracle

    for i in range(5):
        assert streams[i] == oracle.encode(lanes[i])[6:]


def test_native_batch_decode_corrupt(host):
    good = host.encode_stream(make_photo(8, 8))
    with pytest.raises(ValueError):
        host.decode_streams([good, _malicious_stream()], (8, 8, 3))


def test_native_batch_throughput_smoke(host):
    """Parallel speedup sanity (not a strict perf assertion)."""
    import time

    lanes = np.stack([make_photo(64, 64, seed=i) for i in range(8)])
    t0 = time.perf_counter()
    streams = host.encode_images(lanes, n_threads=4)
    dt = time.perf_counter() - t0
    out = host.decode_streams(streams, (64, 64, 3), n_threads=4)
    np.testing.assert_array_equal(out, lanes)
    assert dt < 5.0


def test_native_sliced_primed_container_matches_jax():
    """backend='native' produces byte-identical sliced (primed) containers
    and decodes them, exercising the prior table through the C ABI."""
    import llcomp_jax
    from llcomp_jax import api

    img = make_photo(24, 16)
    for primed in (False, True):
        a = api.compress(img, slices=3, primed=primed)
        b = api.compress(img, slices=3, primed=primed, backend="native")
        assert a == b
        out = api.decompress(b, backend="native")
        np.testing.assert_array_equal(out, img)
