"""Driver contract: entry() compiles single-chip; dryrun_multichip runs."""
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as graft


def test_entry_jittable():
    """The flagship kernel at its full geometry traces to the right
    shapes; at a small geometry, interpreted, it compiles, runs and
    matches the primed oracle lane for lane."""
    from llcomp_jax import encode, oracle

    fn, args = graft.entry()
    imgs, _row = args
    assert imgs.shape == (1024, 16, 512, 3)
    out, lens = jax.eval_shape(fn, *args)
    assert out.shape == (1024, encode._outcap(16 * 512 * 3))
    assert lens.shape == (1024,)

    fn, args = graft.entry(lanes=33, rows=2, width=8, interpret=True)
    out, lens = jax.block_until_ready(jax.jit(fn)(*args))
    imgs = jax.device_get(args[0])
    for s in (0, 17, 32):
        want = oracle.encode_planes(oracle.rct_forward(imgs[s]), primed=True)
        assert bytes(jax.device_get(out[s, : lens[s]])) == want


def test_dryrun_multichip():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    graft.dryrun_multichip(8, interpret=True)


def test_dryrun_multichip_2():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    graft.dryrun_multichip(2, interpret=True)
