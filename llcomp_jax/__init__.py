"""llcomp-jax: a lossless image codec in JAX (llcomp rev-2 bitstream).

Public API (lazy — importing the package does not initialize JAX):
    compress(img)            -> bytes        reference-compatible single stream
    decompress(data)         -> np.ndarray
    compress_sliced(img)     -> bytes        sliced container, device-parallel
    decompress_sliced(data)  -> np.ndarray
"""
from .core.config import REV2, CodecConfig, EXT, EXT_SLICED  # noqa: F401

__version__ = "0.1.0"

_API = ("compress", "decompress", "compress_sliced", "decompress_sliced",
        "reencode_slice")


def __getattr__(name):
    if name in _API:
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
