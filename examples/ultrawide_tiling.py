"""Ultra-wide images: column tiling (container flag bit 3).

A stripe can never be narrower than the image, so very wide images get
very thin stripes under the frozen container-shape policy.  The auto
policy (`api.pick_tiling`) cuts such images into column tiles instead,
for ~2% ratio (docs/DESIGN.md, "Wide images").  This example shows the
knob and what it does to the container.

    python examples/ultrawide_tiling.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from llcomp_jax import api, container


def main() -> int:
    rng = np.random.default_rng(0)
    h, w = 256, 8192
    img = np.clip(
        np.cumsum(rng.integers(-6, 7, (h, w, 3)), axis=1) + 128, 0, 255
    ).astype(np.uint8)

    tw, sh = api.pick_tiling(h, w, 3)
    print(f"policy for {w}x{h}x3: tile_w={tw}, slice_h={sh}")

    blob = api.compress(img, slices="auto")          # auto-tiles
    streams, W, H, C, slice_h, flags, _seed, tile_w = \
        container.unpack_sliced(blob)
    tiles = -(-W // tile_w) if tile_w else 1
    print(f"tiled container: {len(streams)} slices "
          f"({tiles} column tiles x {H // slice_h} stripes of "
          f"{slice_h} row(s)), ratio {img.nbytes / len(blob):.3f}")

    blob_untiled = api.compress(img, slices="auto", tile_w=0)  # opt out
    print(f"untiled container: ratio {img.nbytes / len(blob_untiled):.3f} "
          "(the kernels run at a fraction of the tiled rate; which mode "
          "compresses smaller is content-dependent — the seeded restarts "
          "sometimes beat a long stream's adaptation drift)")

    out = api.decompress(blob)
    assert np.array_equal(out, img), "round-trip mismatch"
    print("round-trip exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
