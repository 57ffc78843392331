"""Bitstream containers.

Two on-disk formats:

* **Single-stream** — byte-identical to the reference CLI output
  (`llcomp.hpp:375-378`): 6-byte header (magic 0x79, channels u8, width u16 LE,
  height u16 LE) followed by one rev-2 entropy stream.  Limited to 65535×65535
  like the reference (which silently *truncates* larger dims through its u16
  fields, `llcomp.hpp:370-373`; we raise instead).

* **Sliced container** (``.llct``, this framework's own) — the image is cut
  into horizontal stripes, each an independent rev-2 stream with its own coder
  and model state.  This is what breaks the format's serial dependence and
  lets encode/decode scale across device lanes, devices and hosts.  Layout (all LE):

      0   4   magic "LLCT"
      4   1   container version (1)
      5   1   codec revision (2)
      6   1   channels
      7   1   flags (bit 0: model primed with tables.PRIOR_TAB[h % 121];
                     bit 1: per-image stored seed — a seed section follows
                     the fixed head and context row h starts at
                     seed[h % 121] instead (see ``seed``);
                     bit 2: per-slice crc32 integrity table;
                     bit 3: column tiles — a tile width follows the fixed
                     head and slices run tile-major (see ``tile_regions``))
      8   4   width  u32
      12  4   height u32
      16  4   slice height u32 (last slice may be shorter)
      20  4   slice count u32
      [flags bit 3 only:]
      24  4   tile width u32 (last tile may be narrower)
      [flags bit 1 only:]
      24  2   seed blob length u16
      26  ..  zlib seed blob (121x8 u8 start states; ~650 B)
      ..  4*n per-slice payload lengths u32
      [flags bit 2 only:]
      ..  4*n per-slice crc32 u32 (arithmetic streams accept most byte
          soups as *some* symbol sequence, so decode-side guards cannot
          catch all corruption; the crc makes detection exact for ~0.1%
          size and powers strict=False / reencode_slice repair)
      ..      concatenated slice payloads, in image order

  Slice payloads are gathered in file order, so a sliced file is a pure
  concatenation plus an index — re-encoding one stripe is an in-place patch
  (the basis of elastic/idempotent re-encode, SURVEY §5).
"""
from __future__ import annotations

import struct
import zlib


from .core.config import REV2, CodecConfig

MAGIC_SLICED = b"LLCT"
CONTAINER_VERSION = 1
FLAG_PRIMED = 1  # context row h starts at tables.PRIOR_TAB[h % 121]
FLAG_SEEDED = 2  # context row h starts at the stored seed[h % 121]
FLAG_CRC = 4     # per-slice crc32 table follows the length index
FLAG_TILED = 8   # column tiles: a u32 tile width follows the fixed head;
#                  slices run tile-major (tile 0 top->bottom, then tile 1,
#                  ...), each over rows [k*slice_h, ...) x cols
#                  [t*tile_w, min((t+1)*tile_w, W)).  Tiling restores full
#                  sublane packing (NSUB) for images whose WIDTH alone
#                  exceeds the fused kernels' VMEM budgets — the encoder
#                  policy is api.pick_tiling; decoders just reassemble.


def pack_single(stream: bytes, width: int, height: int, channels: int,
                cfg: CodecConfig = REV2) -> bytes:
    if not (0 < width <= 0xFFFF and 0 < height <= 0xFFFF):
        raise ValueError(
            f"single-stream format is limited to 65535x65535 (got {width}x{height}); "
            "use the sliced container for larger images"
        )
    return struct.pack("<BBHH", cfg.magic, channels, width, height) + stream


def unpack_single(data: bytes, cfg: CodecConfig = REV2):
    """-> (payload, width, height, channels)."""
    if len(data) < 6 or data[0] != cfg.magic:
        raise ValueError("Invalid magic number")
    channels, width, height = struct.unpack_from("<BHH", data, 1)
    return data[6:], width, height, channels


def pack_sliced(streams: list[bytes], width: int, height: int, channels: int,
                slice_h: int, cfg: CodecConfig = REV2,
                flags: int = 0, seed_blob: bytes | None = None,
                tile_w: int = 0) -> bytes:
    if bool(flags & FLAG_SEEDED) != (seed_blob is not None):
        raise ValueError("seed_blob must be given iff flags bit 1 is set")
    if tile_w and not flags & FLAG_TILED:
        flags |= FLAG_TILED
    if bool(flags & FLAG_TILED) != bool(tile_w):
        raise ValueError("tile_w must be given iff flags bit 3 is set")
    if tile_w and not 0 < tile_w < width:
        raise ValueError(f"tile_w {tile_w} outside (0, width={width})")
    head = MAGIC_SLICED + struct.pack(
        "<BBBBIIII", CONTAINER_VERSION, cfg.revision, channels, flags,
        width, height, slice_h, len(streams),
    )
    if tile_w:
        head += struct.pack("<I", tile_w)
    if seed_blob is not None:
        head += struct.pack("<H", len(seed_blob)) + seed_blob
    index = struct.pack(f"<{len(streams)}I", *(len(s) for s in streams))
    if flags & FLAG_CRC:
        index += struct.pack(
            f"<{len(streams)}I", *(zlib.crc32(s) for s in streams)
        )
    return head + index + b"".join(streams)


def unpack_sliced(data: bytes, cfg: CodecConfig = REV2):
    """-> (streams, width, height, channels, slice_h, flags, seed_blob,
    tile_w).

    ``seed_blob`` is None unless flags bit 1 (FLAG_SEEDED) is set;
    ``tile_w`` is 0 unless flags bit 3 (FLAG_TILED) is set.
    """
    if data[:4] != MAGIC_SLICED:
        raise ValueError("Invalid magic number")
    ver, rev, channels, flags, width, height, slice_h, n = struct.unpack_from(
        "<BBBBIIII", data, 4
    )
    if ver != CONTAINER_VERSION:
        raise ValueError(f"unsupported container version {ver}")
    if rev != cfg.revision:
        raise ValueError(f"unsupported codec revision {rev}")
    if flags & ~(FLAG_PRIMED | FLAG_SEEDED | FLAG_CRC | FLAG_TILED):
        raise ValueError(f"unsupported container flags {flags:#x}")
    off = 24
    tile_w = 0
    if flags & FLAG_TILED:
        (tile_w,) = struct.unpack_from("<I", data, off)
        off += 4
        if not 0 < tile_w < width:
            raise ValueError(f"tile_w {tile_w} outside (0, width={width})")
    seed_blob = None
    if flags & FLAG_SEEDED:
        (blen,) = struct.unpack_from("<H", data, off)
        off += 2
        seed_blob = data[off : off + blen]
        off += blen
    lengths = struct.unpack_from(f"<{n}I", data, off)
    off += 4 * n
    if flags & FLAG_CRC:
        off += 4 * n  # crc table; validate via verify_slices
    streams = []
    for ln in lengths:
        streams.append(data[off : off + ln])
        off += ln
    return streams, width, height, channels, slice_h, flags, seed_blob, tile_w


def verify_slices(data: bytes, cfg: CodecConfig = REV2) -> list[int] | None:
    """Check the per-slice crc32 table (flag bit 2) -> list of corrupt
    slice indices, or None when the container carries no crc table.

    Decode-side guards (e>31 / unterminated symbols) cannot catch all
    corruption — an arithmetic stream decodes most byte soups to *some*
    pixels — so this is the authoritative integrity check, and it runs
    on the host for every backend."""
    if data[:4] != MAGIC_SLICED:
        raise ValueError("Invalid magic number")
    _ver, _rev, _ch, flags, _w, _h, _sh, n = struct.unpack_from(
        "<BBBBIIII", data, 4
    )
    if not flags & FLAG_CRC:
        return None
    off = 24
    if flags & FLAG_TILED:
        off += 4
    if flags & FLAG_SEEDED:
        (blen,) = struct.unpack_from("<H", data, off)
        off += 2 + blen
    lengths = struct.unpack_from(f"<{n}I", data, off)
    off += 4 * n
    crcs = struct.unpack_from(f"<{n}I", data, off)
    off += 4 * n
    bad = []
    for i, (ln, crc) in enumerate(zip(lengths, crcs)):
        if zlib.crc32(data[off : off + ln]) != crc:
            bad.append(i)
        off += ln
    return bad


def slice_bounds(height: int, slice_h: int) -> list[tuple[int, int]]:
    return [(y, min(y + slice_h, height)) for y in range(0, height, slice_h)]


def tile_regions(width: int, height: int, slice_h: int,
                 tile_w: int = 0) -> list[tuple[int, int, int, int]]:
    """Stream-order pixel regions ``(y0, y1, x0, x1)`` of a container.

    ``tile_w == 0`` (untiled): one full-width region per stripe.  Tiled
    (flag bit 3): tile-major order — every stripe of tile 0, then tile 1,
    ... — with the last tile possibly narrower, exactly as the last stripe
    may be shorter.
    """
    rows = slice_bounds(height, slice_h)
    if not tile_w:
        return [(y0, y1, 0, width) for y0, y1 in rows]
    return [
        (y0, y1, x0, min(x0 + tile_w, width))
        for x0 in range(0, width, tile_w)
        for y0, y1 in rows
    ]


def is_sliced(data: bytes) -> bool:
    return data[:4] == MAGIC_SLICED
