"""Property fuzz: random shapes/content round-trip across engines."""
import numpy as np
import pytest

from llcomp_jax import decode as jdec
from llcomp_jax import encode as jenc
from llcomp_jax import oracle


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_roundtrip(seed):
    rng = np.random.default_rng(seed)
    h = int(rng.integers(1, 20))
    w = int(rng.integers(1, 20))
    c = int(rng.choice([1, 2, 3, 4]))
    style = seed % 3
    if style == 0:
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8).astype(np.uint8)
    elif style == 1:
        img = np.full((h, w, c), int(rng.integers(0, 256)), np.uint8)
    else:
        base = rng.integers(0, 256)
        img = np.clip(
            base + np.cumsum(rng.integers(-2, 3, (h, w, c)), axis=1), 0, 255
        ).astype(np.uint8)

    want = oracle.encode(img)
    for engine in ("xla", "gpu"):
        got = jenc.encode_lanes(img[None], engine=engine,
                                interpret=engine == "gpu")[0]
        assert got == want[6:], (engine, h, w, c, style)
    for dec_engine in ("decision", "gpu"):
        out = jdec.decode_lanes([want[6:]], (h, w, c), engine=dec_engine,
                                interpret=dec_engine == "gpu")
        np.testing.assert_array_equal(out[0], img)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_roundtrip_primed(seed):
    """Primed mode (bucketed prior) fuzz: engines agree with the primed
    oracle and round-trip, across random shapes and content styles."""
    rng = np.random.default_rng(1000 + seed)
    h = int(rng.integers(1, 16))
    w = int(rng.integers(1, 16))
    c = int(rng.choice([1, 3, 4]))
    if seed % 2 == 0:
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    else:
        img = np.clip(
            rng.integers(0, 256)
            + np.cumsum(rng.integers(-3, 4, (h, w, c)), axis=0),
            0, 255,
        ).astype(np.uint8)

    want = oracle.encode_planes(oracle.rct_forward(img), primed=True)
    for engine in ("xla", "gpu"):
        got = jenc.encode_lanes(img[None], engine=engine, primed=True,
                                interpret=engine == "gpu")[0]
        assert got == want, (engine, h, w, c)
    for dec_engine in ("decision", "gpu"):
        out = jdec.decode_lanes([want], (h, w, c), engine=dec_engine,
                                primed=True, interpret=dec_engine == "gpu")
        np.testing.assert_array_equal(out[0], img)
