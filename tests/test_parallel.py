"""Mesh-sharded encode/decode on the 8-device virtual CPU mesh."""
import numpy as np
import pytest

import jax

from llcomp_jax import container, oracle, parallel
from tests.conftest import make_photo


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return parallel.make_mesh(8)


def test_sharded_encode_matches_unsharded(mesh8):
    lanes = np.stack([make_photo(8, 16, seed=i) for i in range(16)])
    got = parallel.encode_lanes_sharded(lanes, mesh8)
    for i in range(16):
        assert got[i] == oracle.encode(lanes[i])[6:]


def test_sharded_encode_gpu_engine(mesh8):
    """The GPU kernel dispatched per device via shard_map (Pallas
    interpreter on this CPU mesh) produces the oracle's bytes, including
    lane padding to the device count (10 lanes over 8 devices)."""
    lanes = np.stack([make_photo(2, 8, seed=40 + i) for i in range(10)])
    got = parallel.encode_lanes_sharded(lanes, mesh8, engine="gpu",
                                        interpret=True)
    assert len(got) == 10
    for i in range(10):
        assert got[i] == oracle.encode(lanes[i])[6:]


def test_sharded_encode_gpu_primed_seeded(mesh8):
    """Primed and stored-seed model rows flow through the sharded GPU
    kernel identically to the single-device XLA engine."""
    from llcomp_jax import encode as jenc
    from llcomp_jax import seed as seedmod

    lanes = np.stack([make_photo(2, 8, seed=60 + i) for i in range(3)])
    tab = seedmod.derive(make_photo(16, 16, seed=61))
    for kw in ({"primed": True}, {"seed": tab}):
        got = parallel.encode_lanes_sharded(lanes, mesh8, engine="gpu",
                                            interpret=True, **kw)
        ref = jenc.encode_lanes(lanes, engine="xla", **kw)
        assert got == ref


def test_sharded_decode_gpu_engine(mesh8):
    """Sharded GPU-kernel decode restores every lane, and a corrupt lane
    raises like the XLA shard path."""
    lanes = np.stack([make_photo(2, 8, seed=80 + i) for i in range(9)])
    streams = [oracle.encode(x)[6:] for x in lanes]
    out = parallel.decode_lanes_sharded(streams, (2, 8, 3), mesh8,
                                        engine="gpu", interpret=True)
    np.testing.assert_array_equal(out, lanes)
    from tests.test_native import _malicious_stream

    bad = list(streams)
    bad[3] = _malicious_stream()
    with pytest.raises(ValueError, match="corrupt stream in lanes"):
        parallel.decode_lanes_sharded(bad, (2, 8, 3), mesh8, engine="gpu",
                                      interpret=True)


def test_sharded_encode_nondivisible_lanes(mesh8):
    lanes = np.stack([make_photo(8, 8, seed=i) for i in range(11)])  # 11 % 8 != 0
    got = parallel.encode_lanes_sharded(lanes, mesh8)
    assert len(got) == 11
    for i in range(11):
        assert got[i] == oracle.encode(lanes[i])[6:]


def test_sharded_decode(mesh8):
    lanes = np.stack([make_photo(8, 16, seed=100 + i) for i in range(16)])
    streams = [oracle.encode(l)[6:] for l in lanes]
    out = parallel.decode_lanes_sharded(streams, (8, 16, 3), mesh8)
    np.testing.assert_array_equal(out, lanes)


def test_sharded_image_roundtrip(mesh8):
    img = make_photo(64, 32)
    blob = parallel.compress_sharded(img, mesh8, slices=16)
    assert container.is_sliced(blob)
    np.testing.assert_array_equal(parallel.decompress_sharded(blob, mesh8), img)
    # the sharded container is identical to the single-device sliced container
    import llcomp_jax

    assert blob == llcomp_jax.compress(img, slices=16)


def test_mesh_sizes(mesh8):
    """Same bytes regardless of mesh width (1, 2, 4, 8 devices)."""
    img = make_photo(32, 16)
    blobs = {
        n: parallel.compress_sharded(img, parallel.make_mesh(n), slices=8)
        for n in (1, 2, 4, 8)
    }
    assert len({b for b in blobs.values()}) == 1


def test_corpus_explicit_seeded_with_mesh_roundtrips(mesh8):
    """Round-4 regression (ADVICE r03 medium): compress_corpus(seeded=True,
    mesh=...) must encode WITH the pooled seed table (it used to encode
    with the static prior while packing FLAG_SEEDED + the blob, silently
    corrupting the round trip)."""
    from llcomp_jax import container, corpus
    import llcomp_jax

    imgs = [make_photo(64, 32, seed=90 + i) for i in range(2)]
    blobs, _ = corpus.compress_corpus(imgs, slice_h=8, mesh=mesh8,
                                      seeded=True)
    for blob, img in zip(blobs, imgs):
        assert container.unpack_sliced(blob)[5] & container.FLAG_SEEDED
        np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)
    # and the mesh decode path agrees with the stored table
    outs = corpus.decompress_corpus(blobs, mesh=mesh8)
    for out, img in zip(outs, imgs):
        np.testing.assert_array_equal(out, img)


def test_sharded_seeded_container_roundtrip(mesh8):
    """Seeded containers (flag bit 1) now flow through the sharded path:
    compress_sharded auto-seeds large photo images and decompress_sharded
    decodes with the stored table on the mesh."""
    from llcomp_jax import container

    img = make_photo(256, 256, seed=77)
    blob = parallel.compress_sharded(img, mesh8)
    flags, seed_blob = container.unpack_sliced(blob)[5:7]
    assert flags & container.FLAG_SEEDED and seed_blob
    out = parallel.decompress_sharded(blob, mesh8)
    np.testing.assert_array_equal(out, img)
    # and the single-device decoder agrees
    import llcomp_jax

    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)
