"""Corpus batching: cross-image lane packing, stats, mesh variant."""
import numpy as np
import pytest

import jax

import llcomp_jax
from llcomp_jax import corpus, parallel
from tests.conftest import make_photo


def test_corpus_roundtrip_mixed_sizes():
    imgs = [
        make_photo(16, 16, seed=1),
        make_photo(24, 16, seed=2),
        make_photo(16, 8, seed=3),
        make_photo(13, 16, seed=4),   # ragged height
        make_photo(8, 8, c=4, seed=5),
        make_photo(8, 8, c=1, seed=6),
    ]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=8)
    assert stats.images == 6 and stats.batches >= 1
    assert stats.ratio > 1.0
    outs = corpus.decompress_corpus(blobs)
    for a, b in zip(outs, imgs):
        np.testing.assert_array_equal(a, b)


def test_corpus_blobs_match_single_image_path():
    """Cross-image batching must not change any byte of any container."""
    imgs = [make_photo(16, 16, seed=10 + i) for i in range(3)]
    blobs, _ = corpus.compress_corpus(imgs, slice_h=8)
    for img, blob in zip(imgs, blobs):
        assert blob == llcomp_jax.compress(img, slices=2)


def test_corpus_batch_cap():
    imgs = [make_photo(16, 8, seed=i) for i in range(4)]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=8, max_lanes_per_batch=3)
    assert stats.batches == 3  # 8 lanes in caps of 3
    outs = corpus.decompress_corpus(blobs, max_lanes_per_batch=3)
    for a, b in zip(outs, imgs):
        np.testing.assert_array_equal(a, b)


def test_corpus_sharded():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = parallel.make_mesh(8)
    imgs = [make_photo(16, 16, seed=20 + i) for i in range(4)]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=8, mesh=mesh)
    blobs2, _ = corpus.compress_corpus(imgs, slice_h=8)
    assert blobs == blobs2
    outs = corpus.decompress_corpus(blobs, mesh=mesh)
    for a, b in zip(outs, imgs):
        np.testing.assert_array_equal(a, b)


def test_stats_fields():
    imgs = [make_photo(16, 16)]
    _, stats = corpus.compress_corpus(imgs, slice_h=8)
    d = stats.as_dict()
    assert d["images"] == 1 and d["pixels"] == 256
    assert d["bpp"] > 0 and d["mps"] > 0


def test_corpus_seeded_pooled_roundtrip():
    """Large photo corpora auto-seed (flag bit 1) with ONE pooled table
    shared across the batch; containers round-trip and stay independently
    decodable via api.decompress."""
    from llcomp_jax import container

    imgs = [make_photo(256, 256, seed=30 + i) for i in range(3)]
    blobs, stats = corpus.compress_corpus(imgs, slice_h=8, backend="native")
    seeds = set()
    for b in blobs:
        flags, seed_blob = container.unpack_sliced(b)[5:7]
        assert flags & container.FLAG_SEEDED and seed_blob
        seeds.add(seed_blob)
    assert len(seeds) == 1  # pooled: same table in every container
    outs = corpus.decompress_corpus(blobs, backend="native")
    for a, b in zip(outs, imgs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        llcomp_jax.decompress(blobs[0], backend="native"), imgs[0])
    np.testing.assert_array_equal(llcomp_jax.decompress(blobs[1]), imgs[1])
