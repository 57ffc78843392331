"""Corpus (multi-image) encode/decode: the batched production path.

Packs stripes from *many images* into shared lane batches so the device
engines run at full lane occupancy (single images rarely have enough
stripes to fill the device).  Images are grouped by stripe geometry; each group
becomes one (or a few) device batches.  Per-image containers are reassembled
in order, so the output is indistinguishable from per-image compression.

This is the device analog of the reference CLI's one-file-at-a-time loop
(`llcompc.cpp:14-43`) at production scale, and the unit the multi-host path
shards: each host takes a contiguous span of the corpus manifest.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import api, container
from .core.config import REV2, CodecConfig


@dataclasses.dataclass
class CorpusStats:
    """Structured per-batch observability (SURVEY §5: metrics/logging)."""

    images: int = 0
    pixels: int = 0
    raw_bytes: int = 0
    compressed_bytes: int = 0
    lanes: int = 0
    batches: int = 0
    encode_s: float = 0.0

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(1, self.compressed_bytes)

    @property
    def bpp(self) -> float:
        return 8.0 * self.compressed_bytes / max(1, self.pixels)

    @property
    def mps(self) -> float:
        return self.pixels / 1e6 / max(1e-9, self.encode_s)

    def as_dict(self) -> dict:
        return {
            "images": self.images,
            "pixels": self.pixels,
            "raw_bytes": self.raw_bytes,
            "compressed_bytes": self.compressed_bytes,
            "ratio": round(self.ratio, 3),
            "bpp": round(self.bpp, 3),
            # 6 digits: a one-image corpus on a cold process legitimately
            # measures well under 0.0005 MP/s and must not report 0.0
            "mps": round(self.mps, 6),
            "lanes": self.lanes,
            "batches": self.batches,
            "encode_s": round(self.encode_s, 3),
        }


def _region_plan(shapes, slice_h, tile_w="auto"):
    """Per-image region layout + lockstep batching groups.

    -> (eff, regions_per, groups): ``eff[idx] = (slice_h_i, tile_w_i)``
    (ultra-wide images get their own tiled geometry when ``tile_w`` is
    'auto' — same policy as api.compress — while every other image keeps
    the corpus ``slice_h``), ``regions_per[idx]`` the stream-order
    ``(y0, y1, x0, x1)`` list, and ``groups`` mapping ``(rows, cols, C)``
    to ``(idx, j, region)`` members for lockstep batching — stripes of
    equal shape share lanes across images AND tiles.
    """
    eff: list[tuple[int, int]] = []
    for (H, W, C) in shapes:
        if tile_w == "auto":
            tw, sh = api.pick_tiling(H, W, C)
            if not tw:
                sh = slice_h
        elif tile_w:
            tw = int(tile_w) if 0 < int(tile_w) < W else 0
            sh = api._tile_slice_height(H, tw, C) if tw else slice_h
        else:
            tw, sh = 0, slice_h
        eff.append((sh, tw))
    regions_per = [
        container.tile_regions(s[1], s[0], e[0], e[1])
        for s, e in zip(shapes, eff)
    ]
    groups: dict[tuple[int, int, int], list] = {}
    for idx, regs in enumerate(regions_per):
        C = shapes[idx][2]
        for j, (y0, y1, x0, x1) in enumerate(regs):
            groups.setdefault((y1 - y0, x1 - x0, C), []).append(
                (idx, j, (y0, y1, x0, x1)))
    return eff, regions_per, groups


def compress_corpus(
    images: list[np.ndarray],
    slice_h: int = 16,
    cfg: CodecConfig = REV2,
    max_lanes_per_batch: int = 4096,
    mesh=None,
    primed: bool | None = None,
    backend: str = "jax",
    seeded: bool | None = None,
    tile_w: int | str = "auto",
) -> tuple[list[bytes], CorpusStats]:
    """Compress many images -> per-image sliced containers + stats.

    Stripes from all images share device batches (grouped by geometry, capped
    at ``max_lanes_per_batch`` lanes per dispatch).  ``primed`` applies the
    sliced-mode model prior to every container; None decides once for the
    whole corpus (majority vote of api._pick_primed over a sample) so mixed
    batches stay lockstep.  ``seeded`` stores a POOLED 121-bucket seed table
    (flag bit 1) derived from a corpus sample in every container — batches
    stay single-table and mixed-image, and each container remains
    independently decodable; None = auto (seeded iff primed, like
    api.compress).  ``backend``: 'jax', 'native' (threaded C++ runtime), or
    'auto' (``dispatch.pick``) — identical bytes either way; ``mesh``
    forces the sharded jax path.  ``tile_w``: 'auto' gives budget-clamped
    ultra-wide images the same column tiling api.compress
    gives them (their own tiled slice height; every other image keeps the
    corpus ``slice_h``); 0 never tiles; an int tiles every image wider
    than it.
    """
    from . import encode as jenc

    images = [api._as_image(im) for im in images]
    if primed is None:
        votes = [api._pick_primed(im, cfg) for im in images[:8]]
        primed = sum(votes) * 2 > len(votes)
    if seeded is None:
        # the stored table (~650 B/container) must amortize: same raw-size
        # threshold as api.compress's per-image auto policy
        mean_raw = sum(im.nbytes for im in images) / max(len(images), 1)
        seeded = primed and mesh is None and mean_raw >= 120_000
    seed_tab = seed_blob = None
    if seeded:
        from . import seed as seedmod

        seed_tab = seedmod.derive_pooled(images[:16], cfg)
        seed_blob = seedmod.pack_blob(seed_tab)
        primed = True
    stats = CorpusStats(images=len(images))
    shapes = [im.shape for im in images]
    eff, regions_per, groups = _region_plan(shapes, slice_h, tile_w)

    t0 = time.perf_counter()
    per_image: list[list[bytes | None]] = [
        [None] * len(regs) for regs in regions_per
    ]

    chunks = []
    for (rows, cols, C), members in groups.items():
        for start in range(0, len(members), max_lanes_per_batch):
            chunk = members[start : start + max_lanes_per_batch]
            chunks.append(
                (chunk, np.stack([
                    images[i][y0:y1, x0:x1]
                    for i, _j, (y0, y1, x0, x1) in chunk
                ]))
            )
            stats.lanes += len(chunk)
            stats.batches += 1
    if mesh is not None:
        from . import parallel

        all_streams = [
            parallel.encode_lanes_sharded(lanes, mesh, cfg, primed,
                                          seed=seed_tab)
            for _, lanes in chunks
        ]
    elif api._resolve_backend(backend, lanes=stats.lanes,
                              cfg=cfg) == "native":
        from . import host

        all_streams = [host.encode_images(lanes, primed=primed,
                                          seed=seed_tab)
                       for _, lanes in chunks]
    else:
        all_streams = [
            jenc.encode_lanes(lanes, cfg, primed=primed, seed=seed_tab)
            for _, lanes in chunks
        ]
    for (chunk, _), streams in zip(chunks, all_streams):
        for (i, j, _region), blob in zip(chunk, streams):
            per_image[i][j] = blob
    stats.encode_s = time.perf_counter() - t0

    blobs = []
    for idx, im in enumerate(images):
        H, W, C = im.shape
        blob = container.pack_sliced(
            per_image[idx], W, H, C, eff[idx][0], cfg,
            flags=(container.FLAG_SEEDED if seeded
                   else (container.FLAG_PRIMED if primed else 0))
            | container.FLAG_CRC,
            seed_blob=seed_blob, tile_w=eff[idx][1],
        )
        blobs.append(blob)
        stats.pixels += H * W
        stats.raw_bytes += im.nbytes
        stats.compressed_bytes += len(blob)
    return blobs, stats


def decompress_corpus(
    blobs: list[bytes], cfg: CodecConfig = REV2, max_lanes_per_batch: int = 4096,
    mesh=None, backend: str = "jax",
) -> list[np.ndarray]:
    """Decompress many sliced containers, batching stripes across images."""
    from . import decode as jdec

    metas = [container.unpack_sliced(b, cfg) for b in blobs]
    lanes = sum(len(m[0]) for m in metas)
    native = mesh is None and api._resolve_backend(
        backend, lanes=lanes, cfg=cfg, direction="decode") == "native"
    # group key includes the seed blob so every batch is single-table
    # (containers encoded as one corpus share the pooled table and batch
    # together; foreign containers with other seeds form their own groups)
    groups: dict[tuple, list[tuple[int, tuple, bytes]]] = {}
    for idx, (streams, W, H, C, slice_h, flags, seed_blob,
              tile_w) in enumerate(metas):
        primed = bool(flags & container.FLAG_PRIMED)
        for j, (y0, y1, x0, x1) in enumerate(
                container.tile_regions(W, H, slice_h, tile_w)):
            groups.setdefault(
                (y1 - y0, x1 - x0, C, primed, seed_blob), []
            ).append((idx, (y0, y1, x0, x1), streams[j]))

    outs = [
        np.empty((H, W, C), dtype=np.uint8)
        for (_, W, H, C, _, _, _, _) in metas
    ]
    for (rows, W, C, primed, seed_blob), members in groups.items():
        seed_tab = None
        if seed_blob is not None:
            from . import seed as seedmod

            seed_tab = seedmod.unpack_blob(seed_blob)
        for start in range(0, len(members), max_lanes_per_batch):
            chunk = members[start : start + max_lanes_per_batch]
            if mesh is not None:
                from . import parallel

                lanes = parallel.decode_lanes_sharded(
                    [m[2] for m in chunk], (rows, W, C), mesh, cfg, primed,
                    seed=seed_tab,
                )
            elif native:
                from . import host

                lanes = host.decode_streams([m[2] for m in chunk],
                                            (rows, W, C), primed=primed,
                                            seed=seed_tab)
            else:
                lanes = jdec.decode_lanes([m[2] for m in chunk], (rows, W, C),
                                          cfg, primed=primed, seed=seed_tab)
            for (idx, region, _), lane in zip(chunk, lanes):
                y0, y1, x0, x1 = region
                outs[idx][y0:y1, x0:x1] = lane
    return outs
