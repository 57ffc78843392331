"""Fault-tolerant decode + in-place repair (sliced-container features).

Demonstrates the per-slice independence the container was designed for
(SURVEY §5 fault tolerance): a corrupt stripe costs one stripe, is
reported instead of raising, and heals with a pure splice.

    python examples/fault_tolerance.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import llcomp_jax
from llcomp_jax import api, container


def main() -> None:
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:256, 0:256]
    img = np.clip(
        128 + 64 * np.sin(xx / 17.0)[..., None] + 48 * np.cos(yy / 11.0)[..., None]
        + np.arange(3) * 9 + rng.integers(-3, 4, (256, 256, 3)),
        0, 255,
    ).astype(np.uint8)

    blob = llcomp_jax.compress(img, slices="auto")
    streams, W, H, C, slice_h, flags, seed_blob, _tw = container.unpack_sliced(blob)
    print(f"container: {len(streams)} slices of {slice_h} rows, "
          f"flags={flags:#x} (seeded={bool(flags & container.FLAG_SEEDED)}), "
          f"{len(blob)} bytes (ratio {img.nbytes / len(blob):.2f})")

    # simulate storage corruption: zero slice 3's payload bytes IN the
    # container (decode-side guards alone cannot catch this — an
    # arithmetic stream decodes most byte soups to *some* pixels; the
    # per-slice crc32 table, flag bit 2, is what detects it)
    off = 24 + 2 + len(seed_blob) + 8 * len(streams)  # head+seed+lens+crcs
    start = off + sum(len(s) for s in streams[:3])
    broken = bytearray(blob)
    broken[start : start + len(streams[3])] = bytes(len(streams[3]))
    broken = bytes(broken)

    out, bad_slices = llcomp_jax.decompress(broken, strict=False)
    print(f"non-strict decode: bad slices = {bad_slices}; "
          f"{len(streams) - len(bad_slices)} of {len(streams)} slices exact")

    bounds = container.slice_bounds(H, slice_h)
    for i in bad_slices:  # repair from the source rows (or a replica)
        y0, y1 = bounds[i]
        broken = api.reencode_slice(broken, i, img[y0:y1])
    print("healed == original container:", broken == blob)
    np.testing.assert_array_equal(llcomp_jax.decompress(broken), img)
    print("round-trip exact after repair")


if __name__ == "__main__":
    main()
