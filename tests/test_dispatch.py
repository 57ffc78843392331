"""The one dispatch point (``llcomp_jax.dispatch``) and the compile cache."""
import pytest

import jax

from llcomp_jax import cache, dispatch

_THREADS = 16
_EDGE = dispatch.GPU_LANES_PER_THREAD * _THREADS
_LANES = [1, _EDGE - 1, _EDGE, 4 * _EDGE]


@pytest.fixture
def host_threads(monkeypatch):
    """Pin the host's CPU count, which sets the native runtime's threads."""
    import os

    def pin(n):
        monkeypatch.setattr(os, "cpu_count", lambda: n)
    pin(_THREADS)
    return pin


@pytest.mark.parametrize("direction", ["encode", "decode"])
@pytest.mark.parametrize("lanes", _LANES)
@pytest.mark.parametrize("on", ["gpu", "cpu"])
def test_pick_with_native(on, lanes, direction, host_threads):
    got = dispatch.pick(direction, lanes, on=on, native=True)
    if on == "gpu" and lanes >= _EDGE:
        assert got == "gpu"
    else:
        assert got == "native"


@pytest.mark.parametrize("threads", [1, 4, 16, 64])
def test_crossover_scales_with_host_threads(threads, host_threads):
    """The GPU takes a container once every native thread would walk
    ``GPU_LANES_PER_THREAD`` stripes; a 32-stripe container (one 768x512
    image) stays native on any multi-threaded host."""
    host_threads(threads)
    edge = dispatch.min_device_lanes()
    assert edge == dispatch.GPU_LANES_PER_THREAD * threads
    assert dispatch.pick("decode", edge - 1, on="gpu",
                         native=True) == "native"
    assert dispatch.pick("decode", edge, on="gpu", native=True) == "gpu"
    if threads > 1:
        assert dispatch.pick("encode", 32, on="gpu",
                             native=True) == "native"


def test_crossover_unknown_cpu_count(host_threads):
    host_threads(None)
    assert dispatch.min_device_lanes() == dispatch.GPU_LANES_PER_THREAD


@pytest.mark.parametrize("direction", ["encode", "decode"])
@pytest.mark.parametrize("on", ["gpu", "cpu"])
def test_pick_without_native(on, direction):
    """With no native runtime every geometry goes to the device engine."""
    want = {("gpu", "encode"): "gpu", ("gpu", "decode"): "gpu",
            ("cpu", "encode"): "xla", ("cpu", "decode"): "decision"}
    for lanes in _LANES:
        assert dispatch.pick(direction, lanes, on=on,
                             native=False) == want[(on, direction)]


@pytest.mark.parametrize("direction", ["encode", "decode"])
@pytest.mark.parametrize("on", ["tpu", "rocm", "metal"])
def test_other_platforms_raise(on, direction):
    with pytest.raises(RuntimeError, match=f"no {direction} engine"):
        dispatch.pick(direction, 1024, on=on, native=True)
    with pytest.raises(RuntimeError, match=on):
        dispatch.device_engine(direction, on)


def test_bad_direction_rejected():
    with pytest.raises(ValueError, match="direction"):
        dispatch.device_engine("transcode", "gpu")


def test_default_platform_picks_engine(monkeypatch):
    """With no platform given, the default JAX backend decides."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dispatch.device_engine("decode") == "gpu"
    assert dispatch.pick("encode", dispatch.min_device_lanes(),
                         native=True) == "gpu"


def test_ran_records_the_engine():
    """``RAN`` names the engine that did the work, per direction."""
    import numpy as np

    from llcomp_jax import encode as jenc

    before = dispatch.RAN[("encode", "xla")]
    jenc.encode_lanes(np.zeros((3, 2, 2, 3), np.uint8), engine="xla")
    assert dispatch.RAN[("encode", "xla")] == before + 3


def test_compile_cache_unset_uses_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable()
        assert path == str(cache.DEFAULT_DIR)
        assert cache.DEFAULT_DIR.name == ".jax_cache"
        assert (cache.DEFAULT_DIR.parent / "llcomp_jax").is_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_set_is_left_alone(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        assert cache.enable() is None
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
