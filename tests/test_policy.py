"""The frozen container-shape policy (``api.pick_slice_height`` and
``api.pick_tiling``) against values recorded from the kernels it was first
tuned for: stripe heights and tile widths decide the bytes of every
``slices='auto'`` container, so they must not drift."""
import json
import pathlib

import pytest

from llcomp_jax import api

_GRID = json.loads(
    (pathlib.Path(__file__).parent / "data" / "policy_grid.json").read_text())


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_policy_matches_recorded_grid(channels):
    rows = [r for r in _GRID["rows"] if r[2] == channels]
    assert len(rows) == 800
    for h, w, c, slice_h, tile_w, tile_slice_h in rows:
        assert api.pick_slice_height(h, w, c) == slice_h, (h, w, c)
        assert api.pick_tiling(h, w, c) == (tile_w, tile_slice_h), (h, w, c)


def test_grid_spans_pinned_range():
    hs = {r[0] for r in _GRID["rows"]}
    ws = {r[1] for r in _GRID["rows"]}
    assert min(ws) == 1 and max(ws) == 16384
    assert min(hs) == 1 and max(hs) == 4096
    # the grid covers both the ratio-targeted and the tiled regimes
    assert any(r[4] for r in _GRID["rows"])
    assert any(r[3] == 16 for r in _GRID["rows"])


def test_policy_imports_no_engine():
    """Container shaping is a pure function of geometry: api imports no
    engine module at load time."""
    import subprocess
    import sys

    code = ("import sys, llcomp_jax.api; "
            "bad = [m for m in ('llcomp_jax.kernels', 'llcomp_jax.encode', "
            "'llcomp_jax.decode') if m in sys.modules]; "
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code],
                          cwd=pathlib.Path(__file__).parents[1]).returncode == 0
