"""Production-style corpus compression with stats and mesh sharding.

    python examples/corpus_pipeline.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from llcomp_jax import corpus, parallel


def synth_corpus(n: int = 12):
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        h, w = rng.choice([64, 96, 128]), rng.choice([64, 96])
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(
            np.stack([(xx * 2 + i) % 256, (xx + yy) % 256, (yy * 3) % 256], -1)
            + rng.integers(-3, 4, (h, w, 3)),
            0, 255,
        ).astype(np.uint8)
        out.append(img)
    return out


def main() -> None:
    images = synth_corpus()

    # cross-image lane batching on the default device
    blobs, stats = corpus.compress_corpus(images, slice_h=8)
    print("single-device:", stats.as_dict())

    # same, sharded over every local device (identical bytes)
    mesh = parallel.make_mesh()
    blobs_m, stats_m = corpus.compress_corpus(images, slice_h=8, mesh=mesh)
    assert blobs == blobs_m
    print(f"mesh x{mesh.devices.size}:", stats_m.as_dict())

    outs = corpus.decompress_corpus(blobs)
    assert all(np.array_equal(a, b) for a, b in zip(outs, images))
    print("round-trip bit-exact for", len(images), "images")


if __name__ == "__main__":
    main()
