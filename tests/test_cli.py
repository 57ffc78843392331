"""CLI round-trips through real files (PNG via Pillow, PPM fallback)."""
import pathlib

import numpy as np
import pytest

from llcomp_jax import cli
from llcomp_jax.io import load_image, save_image
from tests.conftest import make_photo


@pytest.fixture
def png(tmp_path):
    img = make_photo(24, 16)
    p = tmp_path / "img.png"
    save_image(p, img)
    return p, img


def test_compress_decompress_cycle(png, tmp_path, capsys):
    p, img = png
    assert cli.main(["compress", str(p)]) == 0
    out = pathlib.Path(str(p) + ".llcomp")
    assert out.exists()
    assert "MP/s" in capsys.readouterr().out

    assert cli.main(["decompress", str(out)]) == 0
    back = load_image(str(out) + ".png")
    np.testing.assert_array_equal(back, img)


def test_compress_sliced_and_info(png, capsys):
    p, img = png
    assert cli.main(["compress", str(p), "--slices", "4"]) == 0
    out = str(p) + ".llct"
    assert cli.main(["info", out]) == 0
    txt = capsys.readouterr().out
    assert "4 slices" in txt and "16x24x3" in txt

    assert cli.main(["decompress", out, "-o", str(p) + ".out.png"]) == 0
    np.testing.assert_array_equal(load_image(str(p) + ".out.png"), img)


def test_info_single(png, capsys):
    p, img = png
    cli.main(["compress", str(p)])
    assert cli.main(["info", str(p) + ".llcomp"]) == 0
    assert "reference-compatible" in capsys.readouterr().out


def test_ppm_roundtrip(tmp_path):
    img = make_photo(9, 7)
    p = tmp_path / "img.ppm"
    save_image(p, img)
    np.testing.assert_array_equal(load_image(p), img)
    assert cli.main(["compress", str(p), "-o", str(tmp_path / "x.llcomp")]) == 0
    assert cli.main(
        ["decompress", str(tmp_path / "x.llcomp"), "-o", str(tmp_path / "y.ppm")]
    ) == 0
    np.testing.assert_array_equal(load_image(tmp_path / "y.ppm"), img)


def test_pgm_grayscale(tmp_path):
    img = make_photo(8, 6, c=1)
    p = tmp_path / "img.pgm"
    save_image(p, img)
    assert cli.main(["compress", str(p)]) == 0
    assert cli.main(["decompress", str(p) + ".llcomp", "-o", str(tmp_path / "o.pgm")]) == 0
    np.testing.assert_array_equal(load_image(tmp_path / "o.pgm"), img)


def test_error_paths(tmp_path, capsys):
    bad = tmp_path / "bad.llcomp"
    bad.write_bytes(b"\x00" * 32)
    assert cli.main(["decompress", str(bad)]) == 1
    assert "error:" in capsys.readouterr().err
    assert cli.main(["info", str(bad)]) == 1


def test_corpus_command(tmp_path, capsys):
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(3):
        save_image(d / f"im{i}.png", make_photo(16, 12, seed=i))
    assert cli.main(["corpus", str(d), "--verify"]) == 0
    out = capsys.readouterr().out
    assert "verified 3 images bit-exact" in out
    assert (d / "im0.png.llct").exists()
    back = load_image(str(d / "im1.png"))
    import llcomp_jax

    np.testing.assert_array_equal(
        llcomp_jax.decompress((d / "im1.png.llct").read_bytes()), back
    )


def test_corpus_empty_dir(tmp_path, capsys):
    d = tmp_path / "empty"
    d.mkdir()
    assert cli.main(["corpus", str(d)]) == 1
    assert "no images" in capsys.readouterr().err


def test_selftest(capsys):
    assert cli.main(["selftest"]) == 0
    assert "PASS" in capsys.readouterr().out
