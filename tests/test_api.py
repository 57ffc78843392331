"""Public API: both container formats, slicing geometry, error paths."""
import numpy as np
import pytest

import llcomp_jax
from llcomp_jax import api, container, oracle
from tests.conftest import make_photo


def test_single_stream_matches_reference_format():
    img = make_photo(16, 16)
    blob = llcomp_jax.compress(img)
    assert blob == oracle.encode(img)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_sliced_roundtrip_even():
    img = make_photo(32, 16)
    blob = llcomp_jax.compress(img, slices=4)
    assert container.is_sliced(blob)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_sliced_roundtrip_ragged():
    """Height not divisible by slice count: last stripe is shorter."""
    img = make_photo(37, 16)
    blob = llcomp_jax.compress(img, slices=5)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_sliced_auto():
    img = make_photo(48, 8)
    blob = llcomp_jax.compress(img, slices="auto")
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_sliced_streams_are_independent_reference_streams():
    """Each stripe payload is a valid headerless rev-2 stream of that stripe."""
    img = make_photo(24, 16)
    blob = llcomp_jax.compress(img, slices=3, primed=False)
    streams, W, H, C, slice_h, flags, _seed, _tw = container.unpack_sliced(blob)
    assert (W, H, C, slice_h, len(streams)) == (16, 24, 3, 8, 3)
    assert flags == container.FLAG_CRC  # integrity table on by default
    for i, s in enumerate(streams):
        stripe = img[i * 8 : (i + 1) * 8]
        assert s == oracle.encode(stripe)[6:]


def test_sliced_primed_streams_match_primed_oracle():
    """Primed stripes = oracle encode with the PRIOR_SUB initial model."""
    img = make_photo(24, 16)
    blob = llcomp_jax.compress(img, slices=3, primed=True)
    streams, W, H, C, slice_h, flags, _seed, _tw = container.unpack_sliced(blob)
    assert flags & container.FLAG_PRIMED
    for i, s in enumerate(streams):
        stripe = img[i * 8 : (i + 1) * 8]
        ref = oracle.encode_planes(oracle.rct_forward(stripe), primed=True)
        assert s == ref
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_primed_improves_photo_ratio():
    """The model prior must pay for itself on photo-like content."""
    img = make_photo(64, 64)
    cold = llcomp_jax.compress(img, slices="auto", primed=False)
    primed = llcomp_jax.compress(img, slices="auto", primed=True)
    assert len(primed) < len(cold)
    np.testing.assert_array_equal(llcomp_jax.decompress(primed), img)
    # the auto heuristic picks the prior for this content
    auto = llcomp_jax.compress(img, slices="auto")
    assert auto == primed


def test_primed_all_decode_engines_agree():
    from llcomp_jax import decode as jdec

    img = make_photo(16, 16)
    blob = llcomp_jax.compress(img, slices=2, primed=True)
    streams, W, H, C, slice_h, flags, _seed, _tw = container.unpack_sliced(blob)
    ref = np.stack([img[:8], img[8:]])
    for engine in ("decision", "gpu"):
        out = jdec.decode_lanes(streams, (8, W, C), engine=engine, primed=True,
                                interpret=engine == "gpu")
        np.testing.assert_array_equal(out, ref)
    # an unprimed decode of primed streams must NOT round-trip silently:
    # either a corruption error or wrong pixels
    try:
        wrong = jdec.decode_lanes(streams, (8, W, C), engine="decision")
        assert not np.array_equal(wrong, ref)
    except ValueError:
        pass


def test_sliced_size_overhead_bounded():
    img = make_photo(64, 64)
    single = len(llcomp_jax.compress(img))
    sliced = len(llcomp_jax.compress(img, slices=8))
    # per-slice model restart costs ratio; must stay modest on photo-like data
    assert sliced < single * 1.35


def test_grayscale_and_2d_input():
    img2d = make_photo(12, 10, c=1)[..., 0]
    blob = llcomp_jax.compress(img2d)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob)[..., 0], img2d)


def test_errors():
    with pytest.raises(TypeError):
        llcomp_jax.compress(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        llcomp_jax.decompress(b"\x00" * 16)
    with pytest.raises(ValueError):
        container.pack_single(b"", 70000, 10, 3)  # reference silently truncates


def test_oracle_backend():
    img = make_photo(8, 8)
    blob = llcomp_jax.compress(img, backend="oracle")
    assert blob == llcomp_jax.compress(img)
    np.testing.assert_array_equal(
        llcomp_jax.decompress(blob, backend="oracle"), img
    )


def test_wide_image_slicing_stays_on_kernel_path():
    """Wide stripes are clamped to the frozen container-shape budget
    (api._fits_budget), and among fitting heights the policy takes the
    tallest at the best group packing — so ultra-wide containers keep
    their seed-era shapes (and bytes) on every engine."""
    for w in (2048, 3840, 8192, 16384):
        sh = api.pick_slice_height(4096, w, 3)
        assert api._fits_budget(sh, w * 3), (w, sh)
        best = max(api._stripe_packing(r * w * 3) for r in (1, 2, 4, 8)
                   if api._fits_budget(r, w * 3))
        assert api._stripe_packing(sh * w * 3) == best, (w, sh)
    # extreme widths over budget at any height keep min_rows
    assert api.pick_slice_height(64, 60000, 3) == 8
    # and a wide-but-short image still round-trips
    img = make_photo(6, 640, c=3)
    blob = llcomp_jax.compress(img, slices=2)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_oversized_stripe_falls_back_to_xla():
    """A stripe far past every old per-stripe budget (3x5000 RGB: 45,000
    symbols in one stream) encodes exactly on the XLA engine and on the
    GPU kernel, which has no budget and needs no fallback."""
    from llcomp_jax import encode as jenc, oracle

    img = make_photo(3, 5000, c=3)
    want = oracle.encode(img)[6:]
    assert jenc.encode_lanes(img[None], engine="xla")[0] == want
    assert jenc.encode_lanes(img[None], engine="gpu", interpret=True)[0] \
        == want


def test_reencode_slice_heals_corrupt_stripe():
    """Fault-tolerance primitive: re-encoding one stripe restores the exact
    original container (slice independence, SURVEY §5)."""
    img = make_photo(32, 16)
    blob = llcomp_jax.compress(img, slices=4)
    streams, W, H, C, slice_h, flags, _seed, _tw = container.unpack_sliced(blob)
    # corrupt slice 2's payload in place
    bad = list(streams)
    bad[2] = bytes([b ^ 0xFF for b in bad[2]])
    broken = container.pack_sliced(bad, W, H, C, slice_h, flags=flags)
    assert broken != blob
    y0, y1 = container.slice_bounds(H, slice_h)[2]
    healed = api.reencode_slice(broken, 2, img[y0:y1])
    assert healed == blob
    np.testing.assert_array_equal(llcomp_jax.decompress(healed), img)


def test_seeded_roundtrip_and_oracle_exact():
    """Stored-seed mode (flag bit 1): per-image table in the container,
    every stripe's context row h resets to seed[h % 121]; streams must
    match the oracle encoding with that table, and decode must restore
    the exact image on jax and native backends."""
    from llcomp_jax import seed as seedmod

    img = make_photo(32, 16, seed=9)
    blob = llcomp_jax.compress(img, slices=4, seeded=True)
    (streams, W, H, C, slice_h, flags, seed_blob,
     _tw) = container.unpack_sliced(blob)
    assert flags & container.FLAG_SEEDED and seed_blob
    tab = seedmod.unpack_blob(seed_blob)
    assert tab.shape == (121, 8)
    for i, s in enumerate(streams):
        stripe = img[i * 8 : (i + 1) * 8]
        assert s == oracle.encode_planes(oracle.rct_forward(stripe),
                                         seed=tab)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)
    np.testing.assert_array_equal(
        llcomp_jax.decompress(blob, backend="native"), img)
    # native encode emits identical containers
    nblob = llcomp_jax.compress(img, slices=4, seeded=True, backend="native")
    assert nblob == blob


def test_seeded_decode_engines_agree():
    from llcomp_jax import decode as jdec, seed as seedmod

    img = make_photo(16, 16, seed=4)
    blob = llcomp_jax.compress(img, slices=2, seeded=True)
    (streams, W, H, C, slice_h, flags, seed_blob,
     _tw) = container.unpack_sliced(blob)
    tab = seedmod.unpack_blob(seed_blob)
    ref = np.stack([img[:8], img[8:]])
    for engine in ("decision", "gpu"):
        out = jdec.decode_lanes(streams, (8, W, C), engine=engine,
                                primed=True, seed=tab,
                                interpret=engine == "gpu")
        np.testing.assert_array_equal(out, ref)


def test_seeded_reencode_slice_heals():
    img = make_photo(32, 16, seed=11)
    blob = llcomp_jax.compress(img, slices=4, seeded=True)
    (streams, W, H, C, slice_h, flags, seed_blob,
     _tw) = container.unpack_sliced(blob)
    bad = list(streams)
    bad[1] = bytes([b ^ 0xAA for b in bad[1]])
    broken = container.pack_sliced(bad, W, H, C, slice_h, flags=flags,
                                   seed_blob=seed_blob)
    y0, y1 = container.slice_bounds(H, slice_h)[1]
    healed = api.reencode_slice(broken, 1, img[y0:y1])
    assert healed == blob


def test_auto_backend_routing(monkeypatch):
    """Workload-aware dispatch: on a GPU host, auto routes single-stream
    and few-lane work to the native runtime (one stream = one lane) and
    keeps many-lane sliced work on the device engines; CPU hosts always
    prefer native; any other platform raises."""
    import jax

    from llcomp_jax import api as a, dispatch

    many = dispatch.min_device_lanes()
    monkeypatch.setattr(a, "_native_available", lambda: True)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert a._resolve_backend("auto", single=True) == "native"
    assert a._resolve_backend("auto", lanes=4) == "native"
    assert a._resolve_backend("auto", lanes=many - 1) == "native"
    assert a._resolve_backend("auto", lanes=many) == "jax"
    assert a._resolve_backend("auto", lanes=many, direction="decode") == "jax"
    assert a._resolve_backend("jax", single=True) == "jax"  # explicit wins
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert a._resolve_backend("auto", lanes=256) == "native"
    monkeypatch.setattr(a, "_native_available", lambda: False)
    assert a._resolve_backend("auto", single=True) == "jax"
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(RuntimeError, match="no encode engine"):
        a._resolve_backend("auto", lanes=256)


def test_single_stream_rejects_primed_and_seeded():
    """primed/seeded are sliced-container flag bits; a single stream has
    nowhere to record them, so an explicit request must fail loudly
    (ADVICE r03: it used to be silently dropped)."""
    img = make_photo(8, 8)
    with pytest.raises(ValueError, match="sliced"):
        llcomp_jax.compress(img, seeded=True)
    with pytest.raises(ValueError, match="sliced"):
        llcomp_jax.compress(img, slices=1, primed=True)
    # auto (None) stays fine for single-stream
    llcomp_jax.compress(img)


def test_seeded_auto_policy():
    """Auto: small images stay unseeded; large photo-like images seed."""
    small = llcomp_jax.compress(make_photo(32, 16), slices=4)
    assert not (container.unpack_sliced(small)[5] & container.FLAG_SEEDED)
    big = llcomp_jax.compress(make_photo(256, 256), slices="auto")
    assert container.unpack_sliced(big)[5] & container.FLAG_SEEDED
    # and it must pay: seeded no larger than the static prior on photo data
    unseeded = llcomp_jax.compress(make_photo(256, 256), slices="auto",
                                   seeded=False)
    assert len(big) <= len(unseeded)


def test_seed_blob_roundtrip_and_validation():
    from llcomp_jax import seed as seedmod

    tab = seedmod.derive(make_photo(64, 64))
    assert tab.shape == (121, 8) and tab.dtype == np.uint8
    assert np.array_equal(seedmod.unpack_blob(seedmod.pack_blob(tab)), tab)
    with pytest.raises(ValueError):
        seedmod.unpack_blob(__import__("zlib").compress(b"short"))


def test_decompress_nonstrict_isolates_corrupt_slice():
    """One corrupt stripe costs one stripe: strict=False returns the good
    slices + a bad-slice report instead of raising away the batch
    (VERDICT r2 item 7), and reencode_slice heals it back to exact."""
    from tests.test_native import _malicious_stream

    img = make_photo(32, 16)
    blob = llcomp_jax.compress(img, slices=4, primed=False)
    streams, W, H, C, slice_h, flags, _seed, _tw = container.unpack_sliced(blob)
    bad = list(streams)
    bad[2] = _malicious_stream()  # reliably trips the e>31 guard
    broken = container.pack_sliced(bad, W, H, C, slice_h, flags=flags)

    # strict (default): the whole decode raises, naming the slice
    with pytest.raises(ValueError, match="2"):
        llcomp_jax.decompress(broken)

    out, bad_slices = llcomp_jax.decompress(broken, strict=False)
    assert bad_slices == [2]
    bounds = container.slice_bounds(H, slice_h)
    for i, (y0, y1) in enumerate(bounds):
        if i != 2:
            np.testing.assert_array_equal(out[y0:y1], img[y0:y1])
    y0, y1 = bounds[2]
    healed = api.reencode_slice(broken, 2, img[y0:y1])
    np.testing.assert_array_equal(llcomp_jax.decompress(healed), img)


def test_decompress_nonstrict_clean_container():
    img = make_photo(24, 16)
    blob = llcomp_jax.compress(img, slices=3)
    out, bad_slices = llcomp_jax.decompress(blob, strict=False)
    assert bad_slices == []
    np.testing.assert_array_equal(out, img)
    # single-stream containers report slice 0 on corruption
    single = llcomp_jax.compress(img)
    out, bad_slices = llcomp_jax.decompress(single, strict=False)
    assert bad_slices == []
    np.testing.assert_array_equal(out, img)


def test_decode_lanes_report_mode():
    from tests.test_native import _malicious_stream
    from llcomp_jax import decode as jdec, encode as jenc

    lanes = np.stack([make_photo(8, 8, seed=60 + i) for i in range(3)])
    streams = jenc.encode_lanes(lanes)
    streams[1] = _malicious_stream()
    out, bad = jdec.decode_lanes(streams, (8, 8, 3), errors="report")
    assert bad == [1]
    np.testing.assert_array_equal(out[0], lanes[0])
    np.testing.assert_array_equal(out[2], lanes[2])


def test_reencode_slice_validates_args():
    img = make_photo(32, 16)
    blob = llcomp_jax.compress(img, slices=4)
    with pytest.raises(IndexError):
        api.reencode_slice(blob, 9, img[:8])
    with pytest.raises(ValueError):
        api.reencode_slice(blob, 0, img[:4])


def test_primed_container_golden_bytes():
    """Byte-golden lock on the primed sliced format (FORMAT.md flag bit 0).

    Locks the container layout AND the bucketed prior semantics
    (tables.PRIOR_TAB): any engine or table drift changes these bytes.
    Recorded from the XLA engine and cross-checked against the oracle
    (test_sliced_primed_streams_match_primed_oracle covers engine equality).
    Re-pinned in round 3 when the per-slice crc32 table (flag bit 2,
    FORMAT.md) was added to the container — the four STREAM payloads are
    byte-identical to the round-2 golden; only the index grew.
    """
    import hashlib

    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:32, 0:48]
    base = np.clip(
        100 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
        + rng.integers(-3, 4, (32, 48)), 0, 255,
    ).astype(np.uint8)
    img = np.repeat(base[..., None], 3, axis=2)
    img[..., 1] += 2
    img[..., 2] += 5
    img = np.ascontiguousarray(img)
    blob = llcomp_jax.compress(img, slices=4, primed=True)
    assert len(blob) == 1012
    assert (
        hashlib.sha256(blob).hexdigest()
        == hashlib.sha256(bytes.fromhex(PRIMED_GOLDEN_HEX)).hexdigest()
    )
    assert blob == bytes.fromhex(PRIMED_GOLDEN_HEX)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


PRIMED_GOLDEN_HEX = (
    "4c4c43540102030530000000200000000800000004000000ef000000ee000000ee"
    "000000f100000069155fa413e1336dd38114fad2bfc7c795653bb5d19648b35ee9"
    "165a7a3da75e6e9268709877c005ff79a8adc10e63f66c09994fcc7733d6fb02e6"
    "bff10d4239e1acc70811bebfdff58c832888827bb456d95e5832f43c7c989d6236"
    "01a985cf78f4a35a8916252bef63aaa85cbc763787fde9f1b1a599039c115b33ed"
    "7fdac94d5e9a78d02f6b792a51330b437b55baf3bae0fce722eca6ed89cc8c52a5"
    "834fd08afc302e84ad27774b511388a8ea54a8ce87132e7bea7a6409464067bb2f"
    "fdf8549248ae3a57a6678ff1e07cc6b1f3e0614e7559cacc5478a50899841dbb9d"
    "c0b1a156ee68e0153ca42214b7a1803528370a576fc0c597c5c6e31fb7c9149565"
    "3bbeb0e2239881eafa46f48fb494682182edc9e25867116a37871ca7795963c131"
    "e07fbe430699514d38584cd4811df7a8ebb4e43ddc2ca1686c443c46b0f500f997"
    "73bb1faedc3566b5aca0acdb28c0586986195a919b745578fad10bc796c441ed59"
    "58f7e6d68b1e6efb3c10a446e6bba221cabf3e165c6a2c3aa2127d00f94114e665"
    "d181fc4aee62751e8aed66bf780c1f4d3635d1649c0c202bcff5bcd21c52dcb564"
    "dba4d68f6bf0f7d6f618db75a4e28a3ff3a0666e5d709b9cf38d8423d0f6c89a7e"
    "f44c7af06fd9352ee5f7d27b207dcb3edda1be61c7c874ae05fb898bb9bebe2e67"
    "25e8fcc73095653bc66328ed6ba1413c8d265a79b923e371c0c1dd59b0040f9bdf"
    "527079128880b6e027638bb3b57dfdbd255b4993508d322baa929bc1f8b0d0b633"
    "f3e32168530ebc940abdb489cbf22277ba62b614703f21fcf7ca72643d19e352e7"
    "234e577a8c1e067f0dec5ee07451cf6ec8a98487be22c3252023b1fa936fdf3b1a"
    "684641c05a02f23a1b9c0bd313dc89df16182691d39003fe4824acb756bbcb4bb6"
    "68023a7b8fbe8d88b7f5d517ebf818c40ebfc8726b8bdc6f0fe7de3eca73054b12"
    "dcef347770f6a74907f5af862c3916cd7f4c25bf699743a773a883f82d9ec84ef0"
    "979fb63016ed06ccba3f65f295653bb7887f7a7600a7e2231d83914662dc0b65b4"
    "07295c82992384ac62e7bb37971d937972ba2ed95b3928a81419efcbedd44ea3cf"
    "6fe420594ea1daff7b3ce858cafb7dde6de0e956a7ce974a5506606bba0d4fc5fc"
    "41d097b05bca5d202bcd4a67769bc33a23fc1ffba5dce8912927ee84d45adca80f"
    "20c8cfed92bf8488c065973b4d5e6ba9769ddbacb10bb4478ce2bd859f75117321"
    "76fd6ca3d418eac82457faeb873c8ac4ad27feee19313259270723c8eb4d7f5a65"
    "1751962fac6bef45e4fff56e71a2ab4c9de471b738c28a02a129b4954e224cf73b"
    "e3b9d33213b17544583289eac750ccec3621f7c2f1a3"
)


def test_crc_detects_silent_corruption():
    """Decode-side guards cannot catch all corruption (arithmetic streams
    decode most byte soups to *some* pixels); the per-slice crc32 table
    (flag bit 2, on by default) makes detection exact and drives
    strict/non-strict behavior without decoding the bad slice."""
    img = make_photo(32, 16, seed=21)
    blob = llcomp_jax.compress(img, slices=4)
    streams, W, H, C, slice_h, flags, _seed, _tw = container.unpack_sliced(blob)
    assert flags & container.FLAG_CRC
    assert container.verify_slices(blob) == []
    # zero slice 1's payload bytes IN the container
    off = 24 + 8 * len(streams) + sum(len(s) for s in streams[:1])
    broken = bytearray(blob)
    broken[off : off + len(streams[1])] = bytes(len(streams[1]))
    broken = bytes(broken)
    assert container.verify_slices(broken) == [1]
    with pytest.raises(ValueError, match="crc"):
        llcomp_jax.decompress(broken)
    out, bad = llcomp_jax.decompress(broken, strict=False)
    assert bad == [1]
    bounds = container.slice_bounds(H, slice_h)
    for i, (y0, y1) in enumerate(bounds):
        if i != 1:
            np.testing.assert_array_equal(out[y0:y1], img[y0:y1])
    healed = api.reencode_slice(broken, 1, img[bounds[1][0]:bounds[1][1]])
    assert healed == blob  # crc recomputed on splice -> exact original


def test_crc_optional_containers_still_decode():
    """Containers without the crc flag (older files) decode unchanged."""
    img = make_photo(16, 16, seed=5)
    from llcomp_jax import api as _api

    streams = _api.encode_stripes(img, container.slice_bounds(16, 8))
    blob = container.pack_sliced(streams, 16, 16, 3, 8, flags=0)
    assert container.verify_slices(blob) is None
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)
