"""Sanitizer-backed conformance (SURVEY §5 "race detection/sanitizers").

The reference is single-threaded so there is nothing to race; the useful
sanitizer check is HEAP correctness: build the reference under
AddressSanitizer and (a) prove the buffer-size patch makes it clean on the
conformance corpus while still emitting our exact bytes, (b) pin the
reference's own overflow bug (SURVEY §2.9) by showing the UNPATCHED encoder
aborts under ASan on incompressible input — the bug our `_outcap` bound
fixes.  Both run the reference in subprocesses; ASan contains the fault.
"""
import subprocess

import numpy as np
import pytest

from tests.conftest import REFERENCE, make_noise, make_photo


@pytest.fixture(scope="session")
def asan_oracles(tmp_path_factory):
    if not (REFERENCE / "llcomp.hpp").exists():
        pytest.skip("reference source not available")
    d = tmp_path_factory.mktemp("asanbuild")
    src = (REFERENCE / "llcomp.hpp").read_text()
    patched = src.replace(
        "std::vector<uint8_t> buffer(size);",
        "std::vector<uint8_t> buffer(size + size / 2 + 4096);",
    )
    main_tpl = (
        '#include "{hdr}"\n'
        "#include <cstdio>\n#include <cstdlib>\n#include <vector>\n"
        "int main(int argc, char** argv) {{\n"
        "  std::vector<uint8_t> in; uint8_t buf[65536]; size_t n;\n"
        "  while ((n = fread(buf, 1, sizeof buf, stdin)) > 0)"
        " in.insert(in.end(), buf, buf+n);\n"
        "  auto out = llcomp::compressImage(in, atoi(argv[1]),"
        " atoi(argv[2]), atoi(argv[3]));\n"
        "  fwrite(out.data(), 1, out.size(), stdout);\n  return 0;\n}}\n"
    )
    exes = {}
    for name, header in (("patched", patched), ("unpatched", src)):
        (d / f"llcomp_{name}.hpp").write_text(header)
        (d / f"main_{name}.cpp").write_text(
            main_tpl.format(hdr=f"llcomp_{name}.hpp"))
        exe = d / f"ref_asan_{name}"
        try:
            subprocess.run(
                ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address",
                 "-fno-omit-frame-pointer", "-o", str(exe),
                 str(d / f"main_{name}.cpp")],
                check=True, capture_output=True, timeout=300,
            )
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            pytest.skip("cannot build ASan reference")
        exes[name] = exe
    return exes


def test_asan_reference_clean_and_byte_exact(asan_oracles):
    """Patched reference under ASan: no heap errors on the conformance
    corpus, and bytes equal ours (the patch cannot change emitted bytes)."""
    from llcomp_jax import oracle

    for img in (make_photo(24, 16, seed=3), make_noise(16, 16, seed=1)):
        h, w, c = img.shape
        r = subprocess.run(
            [str(asan_oracles["patched"]), str(w), str(h), str(c)],
            input=img.tobytes(), capture_output=True, timeout=120,
        )
        assert r.returncode == 0, r.stderr.decode()[:400]
        assert b"AddressSanitizer" not in r.stderr
        assert r.stdout == oracle.encode(img)


def test_asan_pins_reference_overflow_bug(asan_oracles):
    """The UNPATCHED reference heap-overflows on incompressible input
    (SURVEY §2.9) — ASan catches it; our encoder sizes the buffer
    correctly (encode._outcap) and round-trips the same image."""
    import llcomp_jax
    from llcomp_jax import oracle

    img = make_noise(32, 32, seed=7)  # expands: compressed > raw
    r = subprocess.run(
        [str(asan_oracles["unpatched"]), "32", "32", "3"],
        input=img.tobytes(), capture_output=True, timeout=120,
    )
    assert r.returncode != 0 and b"AddressSanitizer" in r.stderr, (
        "expected the reference overflow to trip ASan"
    )
    blob = oracle.encode(img)
    assert len(blob) > img.nbytes  # incompressible indeed
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)
