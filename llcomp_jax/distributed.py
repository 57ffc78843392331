"""Multi-host distribution (jax.distributed + ordered variable-length gather).

The reference has no distribution of any kind (SURVEY §2.13); this layer is
the JAX equivalent of what NCCL/MPI-based frameworks hand-roll:

* ``initialize`` — thin wrapper over ``jax.distributed.initialize`` (reads
  the standard env when args are omitted; safe no-op for single process).
* **Corpus mode** (the production path): images are sharded across hosts at
  file granularity by manifest span — zero cross-host communication; each
  host encodes its span with its local chips and writes its own containers.
* **Single-image pod mode**: one image's stripes sharded over the global
  mesh.  Each host encodes its local stripes, then the variable-length
  per-stripe streams are exchanged with ONE ``process_allgather`` of a
  fixed-capacity padded buffer plus a length vector, and every host
  assembles the identical container in stripe order (lengths trim padding).
  Constant tables ride along as jit constants — broadcast once at compile.

All collective traffic is the final byte gather; the scans themselves are
zero-collective (see ``parallel``).
"""
from __future__ import annotations

import numpy as np

import jax

from . import container
from .core.config import REV2, CodecConfig


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up jax.distributed; no-op if single-process or already up.

    Must run before anything initializes the XLA backend (jax.devices etc.),
    so the already-up check uses is_initialized(), not process_count().
    """
    if jax.distributed.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return  # single-host run
    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def corpus_span(n_items: int, process_id: int | None = None,
                process_count: int | None = None) -> tuple[int, int]:
    """Contiguous [start, stop) span of a corpus manifest owned by a process."""
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count
    per = -(-n_items // pcount)
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def _allgather_streams(streams: list[bytes], n_total: int, my_offset: int):
    """Exchange variable-length byte streams across processes.

    Every process contributes its streams at [my_offset, my_offset+len);
    returns the full ordered list on every process.  Uses one padded
    all-gather (fixed capacity = max length rounded up) plus a length vector.
    """
    if jax.process_count() == 1:
        assert my_offset == 0 and len(streams) == n_total
        return streams

    from jax.experimental import multihost_utils

    lens = np.zeros(n_total, dtype=np.int64)
    for i, s in enumerate(streams):
        lens[my_offset + i] = len(s)
    lens = np.asarray(multihost_utils.process_allgather(lens)).sum(axis=0)

    cap = int(-(-max(1, lens.max()) // 256) * 256)
    buf = np.zeros((n_total, cap), dtype=np.uint8)
    for i, s in enumerate(streams):
        buf[my_offset + i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    # sum-allgather works because each row is owned by exactly one process;
    # dtype pinned: np.sum would otherwise promote uint8 -> int64, making the
    # later .tobytes() emit 8 bytes per element
    buf = np.asarray(multihost_utils.process_allgather(buf)).sum(
        axis=0, dtype=np.uint8
    )
    return [buf[i, : lens[i]].tobytes() for i in range(n_total)]


def compress_image_pod(img: np.ndarray, slice_h: int = 8,
                       cfg: CodecConfig = REV2,
                       primed: bool | None = None) -> bytes:
    """Compress one image with its stripes spread over every chip in the pod.

    Each process encodes the stripes its devices own, then all processes
    assemble the identical container via the ordered padded all-gather.
    The primed decision is a pure function of the (replicated) image, so
    every process picks the same flag without communication.
    """
    from . import api, encode as jenc

    img = api._as_image(img)
    H, W, C = img.shape
    bounds = container.slice_bounds(H, slice_h)
    if primed is None:
        primed = len(bounds) > 1 and api._pick_primed(img, cfg)
    n = len(bounds)
    lo, hi = corpus_span(n)

    by_shape: dict[int, list[int]] = {}
    for i in range(lo, hi):
        y0, y1 = bounds[i]
        by_shape.setdefault(y1 - y0, []).append(i)
    local: dict[int, bytes] = {}
    for rows, idxs in by_shape.items():
        lanes = np.stack([img[bounds[i][0] : bounds[i][1]] for i in idxs])
        for i, blob in zip(idxs, jenc.encode_lanes(lanes, cfg, primed=primed)):
            local[i] = blob

    ordered_local = [local[i] for i in range(lo, hi)]
    streams = _allgather_streams(ordered_local, n, lo)
    return container.pack_sliced(
        streams, W, H, C, slice_h, cfg,
        flags=(container.FLAG_PRIMED if primed else 0) | container.FLAG_CRC,
    )


def compress_corpus_distributed(images: list[np.ndarray], slice_h: int = 8,
                                cfg: CodecConfig = REV2):
    """Each process compresses its manifest span; returns (span, local blobs).

    File-granular sharding needs no communication at all: callers write each
    blob under its manifest name, which is the ordered gather.
    """
    from . import corpus

    lo, hi = corpus_span(len(images))
    blobs, stats = corpus.compress_corpus(list(images[lo:hi]), slice_h, cfg)
    return (lo, hi), blobs, stats
