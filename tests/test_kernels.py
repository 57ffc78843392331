"""GPU entropy kernels (``llcomp_jax.kernels``) against the oracle.

On the CPU the kernels run in the Pallas interpreter (``interpret=True``,
passed explicitly); the ``gpu``-marked tests run them compiled for the card
and skip elsewhere.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from llcomp_jax import decode as jdec
from llcomp_jax import encode as jenc
from llcomp_jax import kernels, oracle
from llcomp_jax.core import tables
from llcomp_jax.core.config import REV2
from tests.conftest import make_noise, make_photo


def _streams(lanes, **kw):
    return [oracle.encode_planes(oracle.rct_forward(x), **kw) for x in lanes]


def _roundtrip(lanes, **kw):
    """GPU-engine encode == oracle, and GPU-engine decode restores it."""
    want = _streams(lanes, **kw)
    got = jenc.encode_lanes(lanes, engine="gpu", interpret=True, **kw)
    assert got == want
    out = jdec.decode_lanes(want, lanes.shape[1:], engine="gpu",
                            interpret=True, **kw)
    np.testing.assert_array_equal(out, lanes)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_channels(c):
    lanes = np.stack([make_photo(5, 7, c=c, seed=s) for s in range(3)])
    _roundtrip(lanes)


@pytest.mark.parametrize("n_lanes", [1, 33, 65])
def test_ragged_lane_counts(n_lanes):
    """Lane counts that are not a multiple of kernels.LANES pad and trim."""
    lanes = np.stack([make_photo(2, 5, seed=s) for s in range(n_lanes)])
    _roundtrip(lanes)


def test_primed():
    lanes = np.stack([make_photo(6, 6, seed=s) for s in range(4)])
    _roundtrip(lanes, primed=True)


def test_seeded():
    from llcomp_jax import seed as seedmod

    tab = seedmod.derive(make_photo(16, 16, seed=3))
    lanes = np.stack([make_photo(6, 6, seed=10 + s) for s in range(4)])
    _roundtrip(lanes, seed=tab)


def test_incompressible_noise():
    """Noise exercises the carry and 0xFF-run paths and the output bound."""
    lanes = np.stack([make_noise(6, 9, seed=s) for s in range(5)])
    _roundtrip(lanes)


@pytest.mark.parametrize("shape", [(1, 1, 1), (9, 1, 1), (1, 64, 1),
                                   (64, 1, 3)])
def test_single_symbol_rows(shape):
    """Width-1 and height-1 geometries, where the row above is a single
    symbol back and the register history holds every neighbour."""
    lanes = np.stack([make_noise(*shape, seed=s) for s in range(2)])
    _roundtrip(lanes)


def _corrupt_batch():
    from tests.test_native import _malicious_stream

    lanes = np.stack([make_photo(4, 4, seed=s) for s in range(3)])
    streams = [oracle.encode(x)[6:] for x in lanes]
    streams[1] = _malicious_stream()
    return lanes, streams


def test_corrupt_lane_raises():
    _lanes, streams = _corrupt_batch()
    with pytest.raises(ValueError, match=r"corrupt stream in lanes \[1\]"):
        jdec.decode_lanes(streams, (4, 4, 3), engine="gpu", interpret=True)


def test_corrupt_lane_reported_others_exact():
    lanes, streams = _corrupt_batch()
    out, bad = jdec.decode_lanes(streams, (4, 4, 3), engine="gpu",
                                 interpret=True, errors="report")
    assert bad == [1]
    np.testing.assert_array_equal(out[[0, 2]], lanes[[0, 2]])


def test_encode_lane_chunking(monkeypatch):
    """A batch over the device byte budget is encoded in whole-program
    chunks with identical bytes."""
    lanes = np.stack([make_photo(3, 4, seed=s) for s in range(70)])
    want = jenc.encode_lanes(lanes, engine="gpu", interpret=True)
    monkeypatch.setattr(jenc, "GPU_BATCH_BYTES", 1)
    assert jenc._lane_chunks(70, 10) == [(0, 32), (32, 64), (64, 70)]
    assert jenc.encode_lanes(lanes, engine="gpu", interpret=True) == want


def test_decode_lane_chunking(monkeypatch):
    lanes = np.stack([make_photo(3, 4, seed=s) for s in range(40)])
    streams = [oracle.encode(x)[6:] for x in lanes]
    monkeypatch.setattr(jenc, "GPU_BATCH_BYTES", 1)
    out = jdec.decode_lanes(streams, (3, 4, 3), engine="gpu", interpret=True)
    np.testing.assert_array_equal(out, lanes)


def test_model_row_packing():
    """Four sub-states per little-endian int32 word, two words per row."""
    row = kernels.model_row(REV2, primed=True)
    assert row.shape == (REV2.num_states // 4,) and row.dtype == np.int32
    b = row.view(np.uint8).reshape(-1, 8)
    np.testing.assert_array_equal(b[:121], tables.PRIOR_TAB)
    np.testing.assert_array_equal(b[121], tables.PRIOR_TAB[0])
    assert not kernels.model_row(REV2).any()
    with pytest.raises(ValueError):
        kernels.model_row(REV2.__class__(substates=4))


def test_unknown_engine_rejected():
    img = make_photo(2, 2)
    with pytest.raises(ValueError, match="unknown encode engine"):
        jenc.encode_lanes(img[None], engine="pallas")
    with pytest.raises(ValueError, match="unknown decode engine"):
        jdec.decode_lanes([b"\0\0"], (2, 2, 3), engine="fused")


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_kernels_lower_for_cuda(direction):
    """Both kernels lower to Triton IR for CUDA at a real stripe width
    (16 x 512 RGB); compiling that IR for the card happens on the card."""
    row = jnp.asarray(kernels.model_row(REV2, primed=True))
    if direction == "encode":
        imgs = jax.ShapeDtypeStruct((64, 16, 512, 3), jnp.uint8)
        traced = kernels.encode_device.trace(
            imgs, row, outcap=jenc._outcap(16 * 512 * 3))
    else:
        data = jax.ShapeDtypeStruct((64, 16384), jnp.uint8)
        traced = kernels.decode_device.trace(data, row, 16, 512, 3)
    text = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert f"llcomp_{direction}" in text


# ----------------------------------------------------------- on the card


def _photo_lanes(n, h, w, c):
    return np.stack([make_photo(h, w, c=c, seed=s) for s in range(n)])


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3, 4])
def test_gpu_kernels_match_native(gpu, c):
    """Compiled kernels at a real stripe width, byte-exact against the
    native runtime, over a lane count that is not a multiple of LANES."""
    from llcomp_jax import host

    lanes = _photo_lanes(100, 16, 512, c)
    want = host.encode_images(lanes, primed=True)
    assert jenc.encode_lanes(lanes, engine="gpu", primed=True) == want
    out = jdec.decode_lanes(want, lanes.shape[1:], engine="gpu", primed=True)
    np.testing.assert_array_equal(out, lanes)


@pytest.mark.gpu
def test_gpu_corrupt_lane_reported(gpu):
    lanes, streams = _corrupt_batch()
    out, bad = jdec.decode_lanes(streams, (4, 4, 3), engine="gpu",
                                 errors="report")
    assert bad == [1]
    np.testing.assert_array_equal(out[[0, 2]], lanes[[0, 2]])
