"""Column-tiled containers (flag bit 3): policy, format, round-trips.

Tiling exists so images whose WIDTH alone clamps their stripes under the
frozen container-shape budget (api._fits_budget; a stripe can never be
narrower than the image — reference analog: none, the reference's scalar
raster loop is width-insensitive, `llcomp.hpp:390-448`) regain the best
group packing: 2048-px tiles at 1-row stripes pack 8 groups.  The
format side is ``container.FLAG_TILED`` + a tile width field; slices run
tile-major and each is an ordinary independent rev-2 stream, so every
engine, the repair splice, and the crc machinery work unchanged.
"""
from __future__ import annotations

import numpy as np
import pytest

import llcomp_jax
from llcomp_jax import api, container


def make_photo(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.integers(-6, 7, (h, w, c)), axis=1)
    base = base + np.cumsum(rng.integers(-2, 3, (h, 1, c)), axis=0)
    return np.clip(base + 128, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- format


def test_tile_regions_untiled_matches_slice_bounds():
    regions = container.tile_regions(640, 48, 8, 0)
    assert regions == [(y0, y1, 0, 640)
                       for y0, y1 in container.slice_bounds(48, 8)]


def test_tile_regions_tile_major_with_remainders():
    # 100 px wide at 40-px tiles -> 40/40/20; 10 rows at 4 -> 4/4/2
    regions = container.tile_regions(100, 10, 4, 40)
    assert len(regions) == 9
    assert regions[0] == (0, 4, 0, 40)
    assert regions[2] == (8, 10, 0, 40)      # short last stripe
    assert regions[3] == (0, 4, 40, 80)      # next tile starts over in y
    assert regions[-1] == (8, 10, 80, 100)   # short and narrow corner


def test_pack_unpack_tile_width_field():
    streams = [b"ab", b"cde", b"f", b"gh"]
    blob = container.pack_sliced(streams, 64, 8, 3, 4, tile_w=32)
    got, W, H, C, sh, flags, seed, tw = container.unpack_sliced(blob)
    assert got == streams and (W, H, C, sh) == (64, 8, 3, 4)
    assert flags & container.FLAG_TILED and tw == 32
    # crc table offsets must account for the tile field
    blob_crc = container.pack_sliced(streams, 64, 8, 3, 4, tile_w=32,
                                     flags=container.FLAG_CRC)
    assert container.verify_slices(blob_crc) == []


def test_pack_tile_width_validation():
    with pytest.raises(ValueError):
        container.pack_sliced([b"x"], 64, 8, 3, 4, tile_w=64)  # >= width
    with pytest.raises(ValueError):
        container.pack_sliced([b"x"], 64, 8, 3, 4,
                              flags=container.FLAG_TILED)  # flag, no width


# ---------------------------------------------------------------- policy


def test_pick_tiling_pure_geometry_table():
    # ultra-wide: tile to the best-packing configuration
    tw, sh = api.pick_tiling(256, 8192, 3)
    assert tw == 2048 and sh == 1
    # already at max packing untiled (2048^2 -> 1-row stripes): no tiling
    assert api.pick_tiling(2048, 2048, 3) == (0, 1)
    # ratio-targeted (unclamped) geometries are never tiled
    assert api.pick_tiling(512, 512, 3) == (0, 16)
    assert api.pick_tiling(256, 256, 4) == (0, 8)
    assert api.pick_tiling(256, 2048, 3)[0] == 0
    # the tiled stripe must beat the untiled packing by >= 2x
    tw4, sh4 = api.pick_tiling(4096, 4096, 3)
    assert tw4 == 2048 and sh4 == 1


def test_pick_tiling_nsub_actually_improves():
    tw, sh = api.pick_tiling(256, 8192, 3)
    n_tiled = api._stripe_packing(sh * tw * 3)
    sh_un = api.pick_slice_height(256, 8192, 3)
    n_un = api._stripe_packing(sh_un * 8192 * 3)
    assert n_tiled >= 2 * n_un


# ------------------------------------------------------------ round-trip


def test_explicit_tile_roundtrip_all_backends_identical():
    img = make_photo(48, 96, seed=11)
    blobs = {
        b: api.compress(img, slices="auto", tile_w=40, backend=b)
        for b in ("native", "jax")
    }
    assert blobs["native"] == blobs["jax"]
    _, _, _, _, _, flags, _, tw = container.unpack_sliced(blobs["jax"])
    assert flags & container.FLAG_TILED and tw == 40
    for b in ("native", "jax"):
        out = api.decompress(blobs["jax"], backend=b)
        assert np.array_equal(out, img)


def test_policy_auto_tiles_ultrawide_and_roundtrips():
    img = make_photo(64, 8192, seed=12)
    blob = api.compress(img, slices="auto", backend="native")
    streams, W, H, C, sh, flags, seed, tw = container.unpack_sliced(blob)
    assert flags & container.FLAG_TILED and tw == 2048 and sh == 1
    assert len(streams) == 4 * 64
    assert np.array_equal(api.decompress(blob, backend="native"), img)
    # tiling can be disabled per call; both forms stay decodable
    blob_un = api.compress(img, slices="auto", tile_w=0, backend="native")
    assert not container.unpack_sliced(blob_un)[5] & container.FLAG_TILED
    assert np.array_equal(api.decompress(blob_un, backend="native"), img)
    # the ratio cost of tiling stays small (<6% on photo-like content)
    assert len(blob) < len(blob_un) * 1.06


def test_tiled_with_explicit_slices_count():
    img = make_photo(32, 64, seed=13)
    blob = api.compress(img, slices=4, tile_w=32, backend="native")
    streams, _, _, _, sh, flags, _, tw = container.unpack_sliced(blob)
    assert tw == 32 and sh == 8 and len(streams) == 8
    assert np.array_equal(api.decompress(blob, backend="native"), img)


def test_tiled_grayscale_roundtrip():
    img = make_photo(40, 80, c=1, seed=14)
    blob = api.compress(img, slices="auto", tile_w=32, backend="native")
    assert np.array_equal(api.decompress(blob, backend="native"), img)


# ------------------------------------------------- repair/fault tolerance


def test_tiled_reencode_slice_splices_region():
    img = make_photo(48, 96, seed=15)
    blob = api.compress(img, slices="auto", tile_w=40, backend="native")
    regions = container.tile_regions(96, 48, 8, 40)
    k = 8  # second tile, second stripe
    y0, y1, x0, x1 = regions[k]
    fixed = api.reencode_slice(blob, k, img[y0:y1, x0:x1])
    assert fixed == blob  # same pixels -> byte-identical splice
    with pytest.raises(ValueError):
        api.reencode_slice(blob, k, img[y0:y1, 0:96])  # full-width stripe


def test_tiled_corruption_reports_and_zeroes_region():
    img = make_photo(48, 96, seed=16)
    blob = api.compress(img, slices="auto", tile_w=40, backend="native")
    streams, W, H, C, sh, flags, _, tw = container.unpack_sliced(blob)
    k = 7
    off = blob.index(streams[k])
    bad = bytearray(blob)
    for i in range(min(4, len(streams[k]))):
        bad[off + i] ^= 0xA5
    with pytest.raises(ValueError):
        api.decompress(bytes(bad), backend="native")
    out, bad_slices = api.decompress(bytes(bad), strict=False,
                                     backend="native")
    assert bad_slices == [k]
    regions = container.tile_regions(W, H, sh, tw)
    y0, y1, x0, x1 = regions[k]
    assert not out[y0:y1, x0:x1].any()
    mask = np.ones((H, W), bool)
    mask[y0:y1, x0:x1] = False
    assert np.array_equal(out[mask], img[mask])


# ------------------------------------------------------------- ecosystem


def test_corpus_decode_mixed_tiled_and_untiled():
    from llcomp_jax import corpus

    tiled_img = make_photo(48, 96, seed=17)
    plain_img = make_photo(48, 96, seed=18)
    blobs = [
        api.compress(tiled_img, slices="auto", tile_w=40, backend="native"),
        api.compress(plain_img, slices="auto", tile_w=0, backend="native"),
    ]
    outs = corpus.decompress_corpus(blobs, backend="native")
    assert np.array_equal(outs[0], tiled_img)
    assert np.array_equal(outs[1], plain_img)


def test_corpus_compress_tiles_ultrawide_members():
    # a mixed corpus: the ultra-wide member gets its own tiled geometry
    # (api.compress policy), the small member keeps the corpus slice_h;
    # both round-trip and the tiled member's container says so
    from llcomp_jax import corpus

    wide = make_photo(16, 8192, seed=22)
    small = make_photo(32, 64, seed=23)
    blobs, stats = corpus.compress_corpus([wide, small], slice_h=8,
                                          backend="native")
    w_meta = container.unpack_sliced(blobs[0])
    s_meta = container.unpack_sliced(blobs[1])
    assert w_meta[7] == 2048 and w_meta[4] == 1      # tiled, 1-row stripes
    assert s_meta[7] == 0 and s_meta[4] == 8         # corpus slice_h kept
    outs = corpus.decompress_corpus(blobs, backend="native")
    assert np.array_equal(outs[0], wide)
    assert np.array_equal(outs[1], small)
    # explicit opt-out restores the untiled corpus geometry
    blobs0, _ = corpus.compress_corpus([wide], slice_h=8, tile_w=0,
                                       backend="native")
    assert container.unpack_sliced(blobs0[0])[7] == 0
    assert np.array_equal(
        corpus.decompress_corpus(blobs0, backend="native")[0], wide)


def test_sharded_compress_tiles_like_api():
    # compress_sharded must shape the same tiled container the single-host
    # auto policy shapes (pod determinism), and round-trip through both
    # the sharded and unsharded decoders.  Small ultra-wide geometry so
    # the CPU-mesh XLA scan stays fast (the GPU kernel under shard_map is
    # test-covered in test_parallel).
    from llcomp_jax import parallel

    img = make_photo(16, 8192, seed=21)
    tw, sh = api.pick_tiling(16, 8192, 3)
    assert tw == 2048 and sh == 1  # the known-clamped ultra-wide geometry
    mesh = parallel.make_mesh(8)
    blob = parallel.compress_sharded(img, mesh)
    assert container.unpack_sliced(blob)[7] == tw
    assert np.array_equal(parallel.decompress_sharded(blob, mesh), img)
    assert np.array_equal(api.decompress(blob, backend="native"), img)
    # byte-identical to the single-host container when the policies match
    flags = container.unpack_sliced(blob)[5]
    blob_api = api.compress(img, slices="auto", backend="native",
                            primed=bool(flags & container.FLAG_PRIMED),
                            seeded=bool(flags & container.FLAG_SEEDED))
    assert blob == blob_api


def test_cli_info_reports_tiling(tmp_path, capsys):
    from llcomp_jax import cli

    img = make_photo(48, 96, seed=19)
    blob = api.compress(img, slices="auto", tile_w=40, backend="native")
    p = tmp_path / "t.llct"
    p.write_bytes(blob)
    assert cli.main(["info", str(p)]) == 0
    out = capsys.readouterr().out
    assert "tiled(40px)" in out and "column tiles" in out


def test_cli_compress_tile_flag(tmp_path, capsys):
    from PIL import Image

    from llcomp_jax import cli

    img = make_photo(48, 96, seed=24)
    src = tmp_path / "img.png"
    Image.fromarray(img).save(src)
    out = tmp_path / "img.llct"
    assert cli.main(["compress", str(src), "-o", str(out),
                     "--slices", "auto", "--tile-w", "40",
                     "--backend", "native"]) == 0
    blob = out.read_bytes()
    assert container.unpack_sliced(blob)[7] == 40
    dec = tmp_path / "roundtrip.png"
    assert cli.main(["decompress", str(out), "-o", str(dec),
                     "--backend", "native"]) == 0
    assert np.array_equal(np.asarray(Image.open(dec)), img)
    # --tile-w 0 disables; single-stream + explicit tile rejects loudly
    assert cli.main(["compress", str(src), "-o", str(out),
                     "--slices", "auto", "--tile-w", "0",
                     "--backend", "native"]) == 0
    assert container.unpack_sliced(out.read_bytes())[7] == 0
    with pytest.raises(ValueError, match="sliced mode"):
        api.compress(img, tile_w=40)


def test_unknown_flag_bits_still_reject():
    # the versioning contract that protects pre-tiling readers from bit 3
    # protects us from bit 4+: unknown flags raise, never decode garbage
    img = make_photo(16, 64, seed=20)
    blob = api.compress(img, slices="auto", tile_w=32, backend="native")
    assert blob[7] & container.FLAG_TILED
    patched = bytearray(blob)
    patched[7] |= 16  # a flag this reader does not know
    with pytest.raises(ValueError, match="flags"):
        container.unpack_sliced(bytes(patched))
