"""Distribution layer: span math, single-process forms, and a REAL
2-process jax.distributed run (localhost coordinator, 4 virtual CPU devices
per rank) that executes _allgather_streams' multi-process gather branch."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import llcomp_jax
from llcomp_jax import distributed, profiling
from tests.conftest import make_photo


def test_corpus_span_math():
    assert distributed.corpus_span(10, 0, 4) == (0, 3)
    assert distributed.corpus_span(10, 3, 4) == (9, 10)
    assert distributed.corpus_span(2, 3, 4) == (2, 2)  # empty tail span
    spans = [distributed.corpus_span(7, p, 3) for p in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == 7
    covered = sum(b - a for a, b in spans)
    assert covered == 7


def test_compress_image_pod_single_process():
    img = make_photo(32, 16)
    blob = distributed.compress_image_pod(img, slice_h=8)
    assert blob == llcomp_jax.compress(img, slices=4)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_compress_corpus_distributed_single_process():
    imgs = [make_photo(16, 16, seed=i) for i in range(3)]
    (lo, hi), blobs, stats = distributed.compress_corpus_distributed(imgs, 8)
    assert (lo, hi) == (0, 3) and len(blobs) == 3
    for img, blob in zip(imgs, blobs):
        np.testing.assert_array_equal(llcomp_jax.decompress(blob), img)


def test_allgather_streams_single():
    s = [b"abc", b"", b"xy"]
    assert distributed._allgather_streams(s, 3, 0) == s


def test_multiprocess_pod_gather(tmp_path):
    """Spawn 2 real processes; both must assemble byte-identical containers.

    Covers distributed.initialize (coordinator bring-up) and the
    multi-process branch of _allgather_streams (padded ordered all-gather),
    which single-process tests cannot reach.  The container must also equal
    the single-process result and decode back to the image.
    """
    with socket.socket() as s:  # find a free localhost port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    worker = Path(__file__).parent / "mp_worker.py"
    outs = [tmp_path / f"rank{r}.llcomp" for r in range(2)]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, "2", str(r), str(outs[r])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(2)
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                tail = err.decode(errors="replace")[-2000:]
                if "distributed" in tail and "initialize" in tail:
                    pytest.skip(f"jax.distributed unavailable here: {tail[-200:]}")
                pytest.fail(f"worker rc={p.returncode}: {tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    blob0, blob1 = outs[0].read_bytes(), outs[1].read_bytes()
    assert blob0 == blob1 and len(blob0) > 0
    img = make_photo(32, 16, seed=3)
    assert blob0 == llcomp_jax.compress(img, slices=4)
    np.testing.assert_array_equal(llcomp_jax.decompress(blob0), img)


def test_multiprocess_pod_gather_4proc_unequal_spans(tmp_path):
    """4 real processes over a 6-stripe image: corpus_span gives unequal
    spans (2/2/1/1), exercising the padded all-gather's ragged tail
    (VERDICT r03 #7).  All ranks must assemble identical containers that
    equal the single-process bytes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    worker = Path(__file__).parent / "mp_worker.py"
    outs = [tmp_path / f"rank{r}.llcomp" for r in range(4)]
    H = 44  # ceil(44/8) = 6 stripes over 4 procs -> spans 2/2/1/1

    spans = [distributed.corpus_span(6, p, 4) for p in range(4)]
    assert len({b - a for a, b in spans}) > 1, spans  # genuinely unequal

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coordinator, "4", str(r),
             str(outs[r]), str(H)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(4)
    ]
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                tail = err.decode(errors="replace")[-2000:]
                if "distributed" in tail and "initialize" in tail:
                    pytest.skip(f"jax.distributed unavailable: {tail[-200:]}")
                pytest.fail(f"worker rc={p.returncode}: {tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    blobs = [o.read_bytes() for o in outs]
    assert len(set(blobs)) == 1 and blobs[0]
    img = make_photo(H, 16, seed=3)
    # byte-equality vs the same slicing done in one process
    from llcomp_jax import api, container
    from llcomp_jax.core.config import REV2

    bounds = container.slice_bounds(H, 8)
    primed = len(bounds) > 1 and api._pick_primed(img, REV2)
    streams = api.encode_stripes(img, bounds, REV2, primed)
    want = container.pack_sliced(
        streams, 16, H, 3, 8, REV2,
        flags=(container.FLAG_PRIMED if primed else 0) | container.FLAG_CRC,
    )
    assert blobs[0] == want
    np.testing.assert_array_equal(llcomp_jax.decompress(blobs[0]), img)


def test_phase_timer():
    t = profiling.PhaseTimer()
    with t("enc"):
        pass
    with t("enc"):
        pass
    rep = t.report()
    assert rep["enc"]["calls"] == 2


def test_annotate_smoke():
    import jax.numpy as jnp

    with profiling.annotate("encode-step"):
        _ = jnp.ones(4).sum()
