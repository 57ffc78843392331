"""Validate generated format tables against independently-recorded rev-2 values."""
import numpy as np

from llcomp_jax.core import tables
from llcomp_jax.core.config import REV2


def test_mps_table():
    mps = tables.NEXT_STATE_MPS
    assert mps.shape == (128,)
    assert list(mps[:6]) == [2, 3, 4, 5, 6, 7]
    assert list(mps[-6:]) == [124, 125, 126, 127, 126, 127]
    # monotone climb: bit parity (MPS identity) is preserved by MPS transitions
    assert np.all(mps % 2 == np.arange(128) % 2)


def test_lps_table_spot():
    lps = tables.NEXT_STATE_LPS
    assert lps.shape == (128,)
    assert list(lps[:10]) == [1, 0, 0, 1, 2, 3, 4, 5, 4, 5]
    assert list(lps[120:128]) == [76, 77, 76, 77, 76, 77, 78, 79]
    assert int(lps.sum()) == 5744  # whole-table checksum vs llcomp.hpp:261-268


def test_prob_table():
    p = tables.STATE_PROB
    assert p.shape == (128,)
    assert p.min() == 7 and p.max() == 247
    assert list(p[:4]) == [123, 131, 117, 137]
    assert list(p[-4:]) == [11, 243, 7, 247]
    # even states predict 0 (P(1) < 128), odd states predict 1
    assert np.all((p[0::2] < 128) & (p[1::2] > 128))
    assert int(p.sum()) == 16256  # symmetric around 127: p[2k] + p[2k+1] == 254
    assert np.all(p[0::2] + p[1::2] == 254)


def test_quant_tables():
    q5, q11 = tables.QUANT5, tables.QUANT11
    # spot values straight from llcomp.hpp:297-333
    assert list(q5[:6]) == [0, 1, 1, 1, 2, 2]
    assert list(q5[125:131]) == [2, 2, 2, -2, -2, -2]
    assert list(q5[-4:]) == [-2, -1, -1, -1]
    assert list(q11[:16]) == [0, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4]
    assert list(q11[32:36]) == [4, 4, 4, 5]
    assert list(q11[-16:]) == [-4] * 5 + [-3] * 7 + [-2] * 3 + [-1]
    assert q11[128] == -5 and q11[127] == 5
    # clamp-then-wrap entry points
    assert tables.quant5(np.array([-1000]))[0] == -2
    assert tables.quant11(np.array([1000]))[0] == 5
    assert tables.quant11(np.array([-128]))[0] == -5


def test_fused_next_state():
    nxt = tables.NEXT_STATE
    for st in [0, 1, 2, 7, 50, 126, 127]:
        mps = st & 1
        assert nxt[st * 2 + mps] == tables.NEXT_STATE_MPS[st]
        assert nxt[st * 2 + (1 - mps)] == tables.NEXT_STATE_LPS[st]


def test_config_model_sizes():
    assert REV2.magic == 0x79
    assert REV2.num_hashes == 7926
    assert REV2.num_states == 63408
    # trimmed model is a strict subset of the reference allocation
    assert REV2.num_states <= (11 * 11 * 11 * 5 * 5 + 1) // 2 * 8


def test_prior_tab_pinned():
    """The bucketed prior is a format constant of flag bit 0 (FORMAT.md):
    any drift would silently break every primed container ever written."""
    import hashlib

    assert tables.PRIOR_TAB.shape == (121, 8)
    assert tables.PRIOR_TAB.dtype == np.uint8
    assert (
        hashlib.sha256(tables.PRIOR_TAB.tobytes()).hexdigest()
        == "399c121254295398e4c48ea165a43e2ad17d58f0b04193bae186f4b5b8c2d11f"
    )
    # the full per-cidx map tiles the table over hash rows
    m = tables.prior_full(121 * 8 * 3 + 16)
    assert m[0:8].tolist() == tables.PRIOR_TAB[0].tolist()
    assert m[121 * 8 : 121 * 8 + 8].tolist() == tables.PRIOR_TAB[0].tolist()
    assert m[13 * 8 : 13 * 8 + 8].tolist() == tables.PRIOR_TAB[13].tolist()
