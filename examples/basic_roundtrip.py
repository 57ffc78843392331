"""Minimal in-memory round-trip (the reference README's missing example).

    python examples/basic_roundtrip.py [image.png]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import llcomp_jax


def main() -> None:
    if len(sys.argv) > 1:
        from llcomp_jax.io import load_image

        img = load_image(sys.argv[1])
    else:
        rng = np.random.default_rng(0)
        yy, xx = np.mgrid[0:256, 0:256]
        img = np.clip(
            np.stack([xx % 256, (xx + yy) % 256, yy % 256], -1)
            + rng.integers(-3, 4, (256, 256, 3)),
            0, 255,
        ).astype(np.uint8)

    # reference-compatible single stream (bit-exact vs llcompc)
    blob = llcomp_jax.compress(img)
    assert np.array_equal(llcomp_jax.decompress(blob), img)
    print(f"single stream: {img.nbytes} -> {len(blob)} bytes "
          f"({img.nbytes / len(blob):.2f}x)")

    # sliced container: every stripe an independent stream, device-parallel
    blob_s = llcomp_jax.compress(img, slices="auto")
    assert np.array_equal(llcomp_jax.decompress(blob_s), img)
    print(f"sliced:        {img.nbytes} -> {len(blob_s)} bytes "
          f"({img.nbytes / len(blob_s):.2f}x)")


if __name__ == "__main__":
    main()
