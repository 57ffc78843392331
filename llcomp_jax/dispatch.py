"""Engine dispatch: the one place that maps platform, direction and
geometry to an engine.

Engines (all byte-identical; choosing among them is policy):

* ``"native"``: the threaded C++ host runtime (``host``);
* ``"gpu"``: the GPU entropy kernels (``kernels``);
* ``"xla"`` / ``"decision"``: the plain XLA encode and decode engines,
  the device engines of a CPU host.

Rules for ``backend="auto"``:

* ``gpu``: containers of at least ``min_device_lanes()`` stripes go to the
  GPU engine; single streams and smaller containers go to native.  A GPU
  lane walks its stripe as one serial chain, so the kernel's time follows
  the symbols per stripe and hardly the stripe count, while the native
  runtime spreads stripes over every host thread: the GPU finishes first
  only once each native thread would have many stripes to walk;
* ``cpu``: native when it builds, else the XLA engines;
* any other platform raises: no engine here was written or checked for it.
"""
from __future__ import annotations

import collections
import os

#: stripes per native worker thread from which the GPU engine finishes a
#: container first, in both directions (bytes are engine-identical, so this
#: is policy).  Measured with tools/crossover.py on an H100 host with 16
#: threads: GPU and native break even at 380-530 stripes for stripes of
#: 6,144 to 36,864 symbols, about 25-33 per thread (PERF.md).
GPU_LANES_PER_THREAD = 32

_DEVICE_ENGINE = {
    ("gpu", "encode"): "gpu",
    ("gpu", "decode"): "gpu",
    ("cpu", "encode"): "xla",
    ("cpu", "decode"): "decision",
}

#: engines that ran in this process, keyed by (direction, engine); the
#: smoke test reads it to prove which engine did the work
RAN: collections.Counter = collections.Counter()


def record(direction: str, engine: str, lanes: int = 1) -> None:
    RAN[(direction, engine)] += lanes


def device_engine(direction: str, on: str | None = None) -> str:
    """The device engine for ``direction`` on platform ``on`` (default:
    the default JAX backend, ``"gpu"`` on CUDA hosts)."""
    import jax

    if direction not in ("encode", "decode"):
        raise ValueError(f"direction must be 'encode' or 'decode', "
                         f"got {direction!r}")
    on = on or jax.default_backend()
    try:
        return _DEVICE_ENGINE[(on, direction)]
    except KeyError:
        raise RuntimeError(
            f"no {direction} engine for platform {on!r}") from None


def native_available() -> bool:
    try:
        from .native import load_library

        load_library()
        return True
    except Exception:
        return False


def min_device_lanes() -> int:
    """Stripes from which ``auto`` hands a container to the GPU engine, for
    the native runtime's thread count on this host (``host``: one per
    CPU)."""
    return GPU_LANES_PER_THREAD * (os.cpu_count() or 1)


def pick(direction: str, lanes: int, on: str | None = None,
         native: bool | None = None) -> str:
    """Engine for ``backend="auto"`` work of ``lanes`` independent streams
    (1 for a single reference-compatible stream)."""
    import jax

    on = on or jax.default_backend()
    engine = device_engine(direction, on)
    if native is None:
        native = native_available()
    if native and (on == "cpu" or lanes < min_device_lanes()):
        return "native"
    return engine
