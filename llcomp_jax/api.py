"""Public in-memory API: compress / decompress.

Mirrors the reference's two-function surface (`compressImage`/`decompressImage`,
`llcomp.hpp:358,461`): pure functions over arrays, no global state.  Adds the
sliced mode that unlocks device parallelism (each stripe is an independent
rev-2 stream; see ``container``).
"""
from __future__ import annotations

import numpy as np

from . import container, dispatch
from .core.config import REV2, CodecConfig
from .dispatch import native_available as _native_available


def _as_image(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3:
        raise ValueError(f"expected [H, W, C] or [H, W], got shape {img.shape}")
    return img


# --- Container-shape policy -------------------------------------------------
# Stripe height and tile width decide the bytes of every ``slices='auto'``
# container, so they are format policy: a pure function of geometry, so that
# every host shapes identical containers.  The rule below is frozen as it
# was first tuned: each stripe must fit a fixed byte budget under two
# per-group footprint formulas (an encode one and a decode one, both over
# 1,024-lane groups), and a stripe "packs" 1, 2, 4 or 8 groups in that
# budget.  These figures are not limits of any engine that runs today; they
# only reproduce the container shapes, and changing them changes the bytes
# and the ratios, which needs its own measured change.  Pinned over a grid
# of geometries by tests/test_policy.py.
_BUDGET = 112 << 20                 # bytes per packed group set
_ROW = 512                          # bytes per symbol row of a 128-lane word
_MODEL = 15_862 * _ROW              # packed model words of one group
_ENC_FIXED = _MODEL + (2 * 32 + 28) * _ROW + (64 << 10)
_DEC_FIXED = _MODEL + (32 + 2 * 256) * _ROW + (64 << 10)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _encode_packing(n_sym: int) -> int:
    """Groups (8, 4, 2, 1) a stripe of ``n_sym`` symbols packs into the
    budget, 0 if none fits."""
    if n_sym + n_sym // 2 + 64 >= (1 << 21):
        return 0
    full = _round16(n_sym + n_sym // 2 + 80)
    safe = _round16(max(n_sym - (n_sym >> 3) - (n_sym >> 5) + 320, 32))
    for groups in (8, 4, 2, 1):
        if any(groups * (_ENC_FIXED + 2 * m * _ROW) <= _BUDGET
               for m in (full, safe)):
            return groups
    return 0


def _decode_fits(n_sym: int, stride: int) -> bool:
    cap = max(4096, -(-(n_sym + 64) // 4096) * 4096)
    return _DEC_FIXED + 3 * stride * _ROW + 2 * cap * 128 <= _BUDGET


def _fits_budget(rows: int, stride: int) -> bool:
    """True when a ``rows``-tall stripe of ``stride`` symbols per row fits
    both footprint formulas."""
    n_sym = rows * stride
    return _encode_packing(n_sym) > 0 and _decode_fits(n_sym, stride)


def _stripe_packing(n_sym: int) -> int:
    return _encode_packing(n_sym) or 1


def pick_slice_height(height: int, width: int, channels: int,
                      target_lanes: int = 32, min_rows: int = 8) -> int:
    """Stripe height balancing lane count against compression.

    More stripes = more parallel lanes but each stream restarts its adaptive
    model, costing ratio on small stripes.  Default: aim for
    ``target_lanes`` stripes but never fewer than ``min_rows`` rows per
    stripe.  target_lanes=32 gives 512-px images 16-row stripes: measured
    on the 1/f natural corpus (round 4), SEEDED 16-row stripes compress
    0.1% SMALLER than the reference's single stream (net 2.791 vs 2.789;
    8-row: 2.767) — each stripe restarts at the stored prior, which beats
    the single stream's cold start.  Wide images take thinner stripes, as
    the frozen budget above dictates (``_fits_budget``); the hash-bucketed
    prior holds sliced ratio >= 2.14 even at 2-row stripes
    (docs/DESIGN.md).  Must stay a pure function of geometry: every host
    shapes identical containers.
    """
    rows, _clamped = _pick_slice_height_ex(height, width, channels,
                                           target_lanes, min_rows)
    return rows


def _pick_slice_height_ex(height: int, width: int, channels: int,
                          target_lanes: int = 32,
                          min_rows: int = 8) -> tuple[int, bool]:
    """(slice height, budget-clamped?) — see ``pick_slice_height``."""
    rows = max(min_rows, -(-height // target_lanes))
    stride = width * channels

    def fast(r: int) -> bool:
        return _fits_budget(r, stride)

    rows = max(1, min(height, rows))
    clamped = False
    while rows >= 2 and not fast(rows):
        rows = max(2, rows // 2) if rows > 2 else 1
        clamped = True
    if clamped and fast(rows):
        # clamped wide images: take the tallest height at the best group
        # packing; ratio-targeted heights (never clamped) are untouched,
        # so the 512-px 16-row seeded stripes keep beating the single
        # stream
        best_r, best_n = rows, _stripe_packing(rows * stride)
        r = rows
        while r > 1:
            r //= 2
            if not fast(r):
                continue
            n = _stripe_packing(r * stride)
            if n > best_n:
                best_r, best_n = r, n
        rows = best_r
    if rows >= 2 or height == 1 or fast(1):
        return max(1, min(height, rows)), clamped
    # extreme width: even one row is over budget
    return max(1, min(height, min_rows)), clamped


# Tiles narrower than this cost ratio fast (each tile restarts prediction
# context at its left edge and its stripes are short streams) without
# buying better packing than a 1024-px tile already does.
MIN_TILE_W = 1024


def _tile_slice_height(height: int, tile_w: int, channels: int) -> int:
    """Stripe height for a column tile: tallest at the best packing.

    Tiles exist only for images already past the ratio-targeted regime
    (budget-clamped), so the height rule is the clamped-width rule: take
    the tallest height whose stripes reach the best packing, starting from
    the geometry-targeted height."""
    stride = tile_w * channels
    r0, _ = _pick_slice_height_ex(height, tile_w, channels)
    best_r, best_n = r0, _stripe_packing(r0 * stride) if _fits_budget(
        r0, stride) else 0
    r = r0
    while r > 1:
        r //= 2
        if not _fits_budget(r, stride):
            continue
        n = _stripe_packing(r * stride)
        if n > best_n:
            best_r, best_n = r, n
    return best_r


def pick_tiling(height: int, width: int, channels: int
                ) -> tuple[int, int]:
    """(tile_w, slice_h) for ``compress(slices='auto')`` — 0 = untiled.

    Column tiling (container flag bit 3) makes the stripe width a policy
    variable for images whose width alone clamps their stripes: tile only
    when the untiled geometry is already budget-clamped (ratio-targeted
    heights are never touched) and tiling at least DOUBLES the packing;
    prefer the widest tile reaching the best packing.  Costs ~2% ratio
    (more, shorter streams; the stored seed holds the floor).  Pure
    function of geometry, like pick_slice_height.
    """
    rows, clamped = _pick_slice_height_ex(height, width, channels)
    if not clamped or width < 2 * MIN_TILE_W:
        return 0, rows
    base_n = _stripe_packing(rows * width * channels) if _fits_budget(
        rows, width * channels) else 1
    best_n, best = base_n, (0, rows)
    for k in range(2, width // MIN_TILE_W + 1):
        tw = -(-width // k)
        if tw < MIN_TILE_W:
            break
        r = _tile_slice_height(height, tw, channels)
        if not _fits_budget(r, tw * channels):
            continue
        n = _stripe_packing(r * tw * channels)
        if n > best_n:
            best_n, best = n, (tw, r)
        if n >= 8:
            break  # k ascends => widest tiles reaching max packing win
    if best[0] and best_n >= 2 * base_n:
        return best
    return 0, rows


# Encoder policy for the sliced-mode model prior (tables.PRIOR_TAB): priming
# helps photographic/noisy content (+13-20% ratio, tools/derive_prior.py) but
# hurts very flat content whose model wants the zero-leaning state-0 start.
# The zero-residual fraction separates the two regimes; the container flag
# records the choice, so this threshold is encoder policy, not format.
PRIMED_ZERO_FRAC_MAX = 0.2


def _pick_primed(img: np.ndarray, cfg: CodecConfig = REV2) -> bool:
    """Prime iff the image's zero-residual fraction is photo-like (low).

    Sampled on up to ~2 MP of 8-row bands (prediction needs two rows of
    context, so bands, not single rows).
    """
    from . import oracle

    H = img.shape[0]
    n_px = img.shape[0] * img.shape[1]
    band = 8
    step = max(1, int(np.ceil(n_px / 2_000_000)) * band)
    zs, n = 0, 0
    for y0 in range(0, H, step):
        v = oracle.rct_forward(img[y0 : y0 + band])
        _, diff = oracle.context_and_residual(v, cfg)
        zs += int((diff == 0).sum())
        n += diff.size
    return (zs / max(n, 1)) < PRIMED_ZERO_FRAC_MAX


def _resolve_backend(backend: str, single: bool = False,
                     lanes: int | None = None,
                     cfg: CodecConfig = REV2,
                     direction: str = "encode") -> str:
    """backend='auto' -> 'native' or 'jax' (the device engines), by
    ``dispatch.pick``.  Every backend emits identical bytes, so this is
    pure policy."""
    if backend == "native" and cfg != REV2:
        # the C++ runtime is compiled for the rev-2 constants only; a
        # non-default cfg would be silently ignored (wrong bytes)
        raise ValueError("backend='native' supports the rev-2 cfg only")
    if backend != "auto":
        return backend
    if cfg != REV2:
        return "jax"  # only the jax/oracle engines honor a custom cfg
    engine = dispatch.pick(direction, 1 if single else (lanes or 1),
                           native=_native_available())
    return "native" if engine == "native" else "jax"


def compress(img, slices: int | str | None = None, cfg: CodecConfig = REV2,
             backend: str = "auto", revision: int = 2,
             primed: bool | None = None,
             seeded: bool | None = None,
             tile_w: int | None = None) -> bytes:
    """Compress a uint8 [H, W, C] image.

    slices=None/1 -> reference-compatible single stream (bit-exact vs llcompc).
    slices='auto' or an int n -> sliced container with n independent stripes,
    encoded lane-parallel on the accelerator.
    backend: 'jax' (device engines), 'native' (threaded C++ host runtime),
    'oracle' (NumPy spec, single-stream only), or 'auto' (``dispatch.pick``:
    the GPU engine for sliced work on a GPU host, native elsewhere) — all
    byte-identical.
    revision=0 -> the legacy llcomp.js bitstream (magic 0x77, float model).
    primed (sliced mode only): start each stripe's context row h at the
    hash-bucketed prior tables.PRIOR_TAB[h % 121] instead of zeros —
    recovers most of the per-stripe restart ratio loss on photographic
    content.  None = decide per image (_pick_primed).
    seeded (sliced mode only): derive a per-image 121-bucket start-state
    table from the image's own statistics and store it in the container
    (flag bit 1, ~650 B zlib) — measured BETTER than the unsliced
    reference stream on the bench corpus (2.22 vs 2.199 at 8-row stripes,
    tools/eval_stored_seed.py) where the static prior is 2.187.  None =
    auto: seeded when priming is on and the image is large enough to
    amortize the stored table (>= ~120 KB raw).
    tile_w (sliced mode only): cut the image into column tiles of this
    width (container flag bit 3), each tile striped independently
    (``pick_tiling``).  None = auto (tile only budget-clamped geometries
    where tiling at least doubles the packing); 0 = never tile.
    """
    img = _as_image(img)
    H, W, C = img.shape

    if revision == 0:
        from . import rev0

        return rev0.encode(img)
    if revision != 2:
        raise ValueError(f"unsupported revision {revision}")

    if slices in (None, 1):
        backend = _resolve_backend(backend, single=True, cfg=cfg)
        if primed or seeded or tile_w:
            # the prior/seed/tiles are properties of the *sliced*
            # container (flag bits 0/1/3); a single reference-compatible
            # stream has no flag byte to record them, so honoring the
            # request is impossible — fail loudly instead of silently
            # dropping it
            raise ValueError(
                "primed/seeded/tile_w apply to sliced mode only; "
                "pass slices='auto' or an int >= 2"
            )
        if backend == "oracle":
            from . import oracle

            return oracle.encode(img, cfg)
        if backend == "native":
            from . import host

            return container.pack_single(host.encode_stream(img), W, H, C, cfg)
        from . import encode

        stream = encode.encode_lanes(img[None], cfg)[0]
        return container.pack_single(stream, W, H, C, cfg)

    if slices == "auto":
        if tile_w is None:
            tw, slice_h = pick_tiling(H, W, C)
        elif tile_w:
            tw = int(tile_w)
            slice_h = _tile_slice_height(H, tw, C)
        else:
            tw, slice_h = 0, pick_slice_height(H, W, C)
    else:
        n = int(slices)
        if n < 1:
            raise ValueError(f"slices must be >= 1 or 'auto', got {n}")
        slice_h = max(1, -(-H // n))
        tw = int(tile_w) if tile_w else 0
    if tw and not 0 < tw < W:
        raise ValueError(f"tile_w {tw} outside (0, width={W})")
    regions = container.tile_regions(W, H, slice_h, tw)
    backend = _resolve_backend(backend, lanes=len(regions), cfg=cfg)
    if primed is None:
        primed = len(regions) > 1 and _pick_primed(img, cfg)
    if seeded is None:
        seeded = primed and H * W * C >= 120_000
    if seeded:
        from . import seed as seedmod

        tab = seedmod.derive(img, cfg)
        streams = _encode_regions(img, regions, cfg, True, backend=backend,
                                  seed=tab)
        return container.pack_sliced(
            streams, W, H, C, slice_h, cfg,
            flags=container.FLAG_SEEDED | container.FLAG_CRC,
            seed_blob=seedmod.pack_blob(tab), tile_w=tw,
        )
    streams = _encode_regions(img, regions, cfg, primed, backend=backend)
    return container.pack_sliced(
        streams, W, H, C, slice_h, cfg,
        flags=(container.FLAG_PRIMED if primed else 0) | container.FLAG_CRC,
        tile_w=tw,
    )


def encode_stripes(img: np.ndarray, bounds, cfg: CodecConfig = REV2,
                   primed: bool = False, backend: str = "jax",
                   seed=None) -> list[bytes]:
    """Encode stripes as independent streams, batching equal-shaped stripes."""
    W = img.shape[1]
    return _encode_regions(img, [(y0, y1, 0, W) for y0, y1 in bounds], cfg,
                           primed, backend=backend, seed=seed)


def _encode_regions(img: np.ndarray, regions, cfg: CodecConfig = REV2,
                    primed: bool = False, backend: str = "jax",
                    seed=None) -> list[bytes]:
    """Encode ``(y0, y1, x0, x1)`` pixel regions as independent streams,
    batching equal-shaped regions into one lane batch (tiles of equal
    width share lanes with each other across the whole image, so a tiled
    wide image fills lanes exactly like a corpus batch)."""
    from . import encode

    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, (y0, y1, x0, x1) in enumerate(regions):
        by_shape.setdefault((y1 - y0, x1 - x0), []).append(i)
    out: list[bytes | None] = [None] * len(regions)
    for idxs in by_shape.values():
        lanes = np.stack([img[y0:y1, x0:x1]
                          for y0, y1, x0, x1 in (regions[i] for i in idxs)])
        if backend == "native":
            from . import host

            streams = host.encode_images(lanes, primed=primed, seed=seed)
        else:
            streams = encode.encode_lanes(lanes, cfg, primed=primed,
                                          seed=seed)
        for i, blob in zip(idxs, streams):
            out[i] = blob
    return out  # type: ignore[return-value]


def decompress(data: bytes, cfg: CodecConfig = REV2, backend: str = "auto",
               strict: bool = True):
    """Decompress either container format back to a uint8 [H, W, C] image.

    backend: 'jax', 'native', 'oracle' (single-stream only), or 'auto'
    (``dispatch.pick``, as for ``compress``).
    strict: when False (sliced containers), a corrupt slice no longer
    raises away the whole image — returns ``(img, bad_slices)`` where
    every slice NOT listed in ``bad_slices`` holds its exact pixels and
    flagged slices hold undefined bytes.  Repair with
    ``reencode_slice(data, i, rows)`` per flagged index.  Single-stream
    containers have one slice, so strict=False returns ``(img, [0])`` on
    corruption.
    """
    data = bytes(data)
    if container.is_sliced(data):
        (streams, W, H, C, slice_h, flags, seed_blob,
         tile_w) = container.unpack_sliced(data, cfg)
        regions = container.tile_regions(W, H, slice_h, tile_w)
        backend = _resolve_backend(backend, lanes=len(regions), cfg=cfg,
                                   direction="decode")
        tab = None
        if flags & container.FLAG_SEEDED:
            from . import seed as seedmod

            tab = seedmod.unpack_blob(seed_blob)
        # authoritative integrity check (flag bit 2): decode-side guards
        # cannot catch all corruption (an arithmetic stream decodes most
        # byte soups to *some* pixels) — crc failures are known before
        # any decoding and those slices are skipped, not decoded
        badcrc = container.verify_slices(data, cfg) or []
        if badcrc and strict:
            raise ValueError(f"corrupt stream in slices {badcrc} "
                             "(crc mismatch)")
        return _decode_regions(streams, regions, (H, W, C), cfg,
                               primed=bool(flags & container.FLAG_PRIMED),
                               backend=backend, strict=strict, seed=tab,
                               skip=badcrc)

    if data[:1] == b"\x77":  # legacy revision-0 stream (llcomp.js)
        from . import rev0

        return rev0.decode(data)

    payload, W, H, C = container.unpack_single(data, cfg)
    backend = _resolve_backend(backend, single=True, cfg=cfg,
                               direction="decode")

    def _single():
        if backend == "oracle":
            from . import oracle

            return oracle.decode(data, cfg)
        if backend == "native":
            from . import host

            return host.decode_stream(payload, (H, W, C))
        from . import decode

        return decode.decode_lanes([payload], (H, W, C), cfg)[0]

    if strict:
        return _single()
    try:
        return _single(), []
    except ValueError:
        return np.zeros((H, W, C), np.uint8), [0]


def decode_stripes(streams, bounds, W: int, C: int, cfg: CodecConfig = REV2,
                   primed: bool = False, backend: str = "jax",
                   strict: bool = True, seed=None, skip=()):
    """Decode a sliced container's full-width stripes into one image.

    See ``_decode_regions`` (this is the untiled special case kept for
    the public surface and the distributed/parallel callers).
    """
    H = bounds[-1][1]
    return _decode_regions(streams, [(y0, y1, 0, W) for y0, y1 in bounds],
                           (H, W, C), cfg, primed=primed, backend=backend,
                           strict=strict, seed=seed, skip=skip)


def _decode_regions(streams, regions, shape: tuple[int, int, int],
                    cfg: CodecConfig = REV2, primed: bool = False,
                    backend: str = "jax", strict: bool = True, seed=None,
                    skip=()):
    """Decode per-region streams into one ``shape`` image.

    ``regions`` are stream-order ``(y0, y1, x0, x1)`` pixel rectangles
    (``container.tile_regions``); equal-shaped regions batch into one
    lane call.  strict=False returns ``(img, bad_slices)`` instead of
    raising on a corrupt slice: the flagged regions' pixels are
    undefined, every other region is exact (per-slice stream
    independence, SURVEY §5; the repair primitive is ``reencode_slice``).
    ``skip``: slice indices already known corrupt (crc mismatches) —
    zero-filled and reported without decoding.
    """
    from . import decode

    H, W, C = shape
    out = np.empty((H, W, C), dtype=np.uint8)
    bad_slices: list[int] = list(skip)
    for i in bad_slices:
        y0, y1, x0, x1 = regions[i]
        out[y0:y1, x0:x1] = 0
    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, (y0, y1, x0, x1) in enumerate(regions):
        if i not in bad_slices:
            by_shape.setdefault((y1 - y0, x1 - x0), []).append(i)
    for (rows, cols), idxs in by_shape.items():
        if backend == "native":
            from . import host

            # the native runtime decodes streams independently: isolate
            # faults per slice by falling back to one-at-a-time on error,
            # so strict mode can name the corrupt slices like the jax path
            try:
                lanes = host.decode_streams(
                    [streams[i] for i in idxs], (rows, cols, C),
                    primed=primed, seed=seed,
                )
            except ValueError as batch_err:
                lanes = np.zeros((len(idxs), rows, cols, C), np.uint8)
                shape_bad = []
                for k, i in enumerate(idxs):
                    try:
                        lanes[k] = host.decode_streams(
                            [streams[i]], (rows, cols, C), primed=primed,
                            seed=seed)[0]
                    except ValueError:
                        shape_bad.append(i)
                if strict:
                    if shape_bad:
                        raise ValueError(
                            "corrupt stream in slices "
                            f"{sorted(shape_bad)}") from batch_err
                    raise  # batch-level failure with no culprit slice
                bad_slices.extend(shape_bad)
        else:
            lanes, bad = decode.decode_lanes(
                [streams[i] for i in idxs], (rows, cols, C), cfg,
                primed=primed, errors="report", seed=seed,
            )
            if bad:
                if strict:
                    raise ValueError(
                        "corrupt stream in slices "
                        f"{sorted(idxs[b] for b in bad)}"
                    )
                bad_slices.extend(idxs[b] for b in bad)
        for k, i in enumerate(idxs):
            y0, y1, x0, x1 = regions[i]
            out[y0:y1, x0:x1] = lanes[k]
    if strict:
        return out
    return out, sorted(bad_slices)


def reencode_slice(data: bytes, index: int, stripe, cfg: CodecConfig = REV2) -> bytes:
    """Replace one stripe of a sliced container in place (elastic re-encode).

    ``stripe`` is the uint8 pixel block for that slice (shape checked against
    the container geometry).  Because every slice is an independent stream
    with its own index entry (``container`` layout), repairing a damaged or
    stale stripe is a pure splice — no other payload byte moves.  This is the
    fault-tolerance primitive SURVEY §5 calls for: a lost/corrupt shard is
    healed by re-encoding only its rows.
    """
    (streams, W, H, C, slice_h, flags, seed_blob,
     tile_w) = container.unpack_sliced(data, cfg)
    regions = container.tile_regions(W, H, slice_h, tile_w)
    if not 0 <= index < len(regions):
        raise IndexError(
            f"slice index {index} out of range [0, {len(regions)})")
    stripe = _as_image(stripe)
    y0, y1, x0, x1 = regions[index]
    if stripe.shape != (y1 - y0, x1 - x0, C):
        raise ValueError(
            f"stripe shape {stripe.shape} != expected "
            f"{(y1 - y0, x1 - x0, C)}"
        )
    from . import encode

    tab = None
    if flags & container.FLAG_SEEDED:
        from . import seed as seedmod

        tab = seedmod.unpack_blob(seed_blob)
    streams = list(streams)
    streams[index] = encode.encode_lanes(
        stripe[None], cfg, primed=bool(flags & container.FLAG_PRIMED),
        seed=tab,
    )[0]
    return container.pack_sliced(streams, W, H, C, slice_h, cfg, flags=flags,
                                 seed_blob=seed_blob, tile_w=tile_w)


# Sliced-format aliases used by the package __init__.
def compress_sliced(img, slices: int | str = "auto", cfg: CodecConfig = REV2) -> bytes:
    return compress(img, slices=slices, cfg=cfg)


def decompress_sliced(data: bytes, cfg: CodecConfig = REV2) -> np.ndarray:
    return decompress(data, cfg)
