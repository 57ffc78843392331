import os
import subprocess
import sys
from pathlib import Path

# Tests run on the CPU with a deterministic 8-device virtual mesh: sharding
# logic is exercised without accelerators, and the codec is integer end to
# end, so CPU and GPU bytes are identical.  The GPU kernels run here in the
# Pallas interpreter; tests that need the card are marked ``gpu`` and skip
# here (see the ``gpu`` fixture).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from llcomp_jax import cache  # noqa: E402

# persistent compile cache (<checkout>/.jax_cache unless the environment
# names one): cache-loaded executables skip XLA CPU compilation
cache.enable()

REFERENCE = Path("/root/reference")


def make_photo(h, w, c=3, seed=42, noise=3):
    """Smooth 2-D gradient + small uniform noise — the BASELINE.md test signal."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        128
        + 64 * np.sin(2 * np.pi * xx / max(w, 1) * 1.5)
        + 64 * np.cos(2 * np.pi * yy / max(h, 1) * 1.1)
    )
    img = base[..., None] + np.arange(c)[None, None, :] * 10.0
    img = img + rng.integers(-noise, noise + 1, size=(h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_noise(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables_between_modules():
    """Release XLA CPU executables at module boundaries.

    The full suite compiles several hundred programs into one process; past
    ~150 tests the CPU backend died (SIGABRT/SIGSEGV, no message) inside
    ``backend_compile_and_load`` on the next large compile — deterministic
    at the same test, independent of the native runtime (reproduced with
    LLCT_NO_NATIVE=1), and absent in any subset run.  Dropping the jit
    caches between modules keeps accumulated compiler state under the
    threshold.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless a GPU is the default JAX platform (decided here, at run
    time, never at import: every xdist worker must collect the same
    tests).  On the card, ``python chip_smoke.py`` runs the ``gpu`` tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (runs on the card via chip_smoke.py)")


@pytest.fixture(scope="session")
def photo_64():
    return make_photo(64, 64)


@pytest.fixture(scope="session")
def ref_oracle(tmp_path_factory):
    """Build the C++ reference as a conformance oracle, if available.

    The only modification is the output-buffer size (the reference overflows on
    tiny/incompressible images, SURVEY §2.9); that cannot change emitted bytes.
    Tests using this fixture are skipped when the reference isn't present.
    """
    if not (REFERENCE / "llcomp.hpp").exists():
        pytest.skip("reference source not available")
    d = tmp_path_factory.mktemp("refbuild")
    patched = d / "llcomp_patched.hpp"
    src = (REFERENCE / "llcomp.hpp").read_text()
    src = src.replace(
        "std::vector<uint8_t> buffer(size);",
        "std::vector<uint8_t> buffer(size + size / 2 + 4096);",
    )
    patched.write_text(src)
    main = d / "main.cpp"
    main.write_text(
        '#include "llcomp_patched.hpp"\n'
        "#include <cstdio>\n#include <cstdlib>\n#include <vector>\n"
        "int main(int argc, char** argv) {\n"
        "  std::vector<uint8_t> in; uint8_t buf[65536]; size_t n;\n"
        "  while ((n = fread(buf, 1, sizeof buf, stdin)) > 0) in.insert(in.end(), buf, buf+n);\n"
        "  if (argv[1][0] == 'c') {\n"
        "    auto out = llcomp::compressImage(in, atoi(argv[2]), atoi(argv[3]), atoi(argv[4]));\n"
        "    fwrite(out.data(), 1, out.size(), stdout);\n"
        "  } else {\n"
        "    auto img = llcomp::decompressImage(in);\n"
        "    fwrite(img.pixels.data(), 1, img.pixels.size(), stdout);\n"
        "  }\n  return 0;\n}\n"
    )
    exe = d / "ref_oracle"
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-DNDEBUG", "-o", str(exe), str(main)],
            check=True, capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        pytest.skip("cannot build reference oracle")

    class Ref:
        def encode(self, img):
            img = np.asarray(img, dtype=np.uint8)
            h, w, c = img.shape
            r = subprocess.run(
                [str(exe), "c", str(w), str(h), str(c)],
                input=img.tobytes(), capture_output=True, check=True,
            )
            return r.stdout

        def decode(self, data, shape):
            r = subprocess.run([str(exe), "d"], input=bytes(data), capture_output=True, check=True)
            return np.frombuffer(r.stdout, dtype=np.uint8).reshape(shape)

    return Ref()
