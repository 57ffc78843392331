"""Batched lane-parallel encoder (JAX).

Two device engines emit the same bytes:

* **gpu** (``kernels.encode_device``): an XLA precompute of each symbol's
  context hash and folded residual, then one Pallas/Triton kernel that
  walks every stream with its own adaptive model and range coder, one
  stream per thread.  The GPU engine of ``dispatch``.

* **xla** (the CPU device engine, and the plain reference of the GPU
  kernel): **model-free encode**.  The encoder's adaptive model walk is
  fully determined by the decision stream, which is computable in advance,
  so sorting each lane's decisions by context turns the 63 KB/lane model
  into a one-byte-per-lane carry (reset at context-run starts).
  Probabilities then return to stream order and the range-coder scan
  carries just four scalars per lane.

Reference semantics: encode loop `llcomp.hpp:390-449`, model addressing
`llcomp.hpp:440-441`, probability/update protocol `llcomp.hpp:439-444`.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from . import coder, dispatch, profiling
from .core import tables, transform
from .core.config import REV2, CodecConfig


def _bucket(n: int, quantum: int = 8192) -> int:
    """Round a scan length up to a bucket to bound jit recompiles."""
    return max(quantum, -(-n // quantum) * quantum)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _count(imgs: jnp.ndarray, cfg: CodecConfig = REV2) -> jnp.ndarray:
    v = transform.rct_forward(imgs)
    _, diff = transform.context_and_residual(v, cfg)
    return transform.count_bins(diff.reshape(diff.shape[0], -1))


def _compact_decisions(imgs: jnp.ndarray, cap: int, cfg: CodecConfig):
    """[S, H, W, C] -> per-lane front-packed decisions [S, cap] (cidx*2+bit, -1 pad).

    All flat 1-D scatters with absolute offsets.
    """
    S = imgs.shape[0]
    v = transform.rct_forward(imgs)
    hash_, diff = transform.context_and_residual(v, cfg)
    ctx, bit, valid, _ = transform.binarize(diff.reshape(S, -1), cfg)

    cidx = hash_.reshape(S, -1, 1) * cfg.substates + ctx
    packed = (cidx << 1) | bit
    flatp = packed.reshape(-1)
    flatv = valid.reshape(S, -1)
    pos = jnp.cumsum(flatv.astype(jnp.int32), axis=1) - 1
    lane = jax.lax.broadcasted_iota(jnp.int32, flatv.shape, 0)
    dst = jnp.where(flatv, lane * cap + pos, S * cap).reshape(-1)
    return (
        jnp.full((S * cap,), -1, jnp.int32)
        .at[dst].set(flatp, mode="drop")
        .reshape(S, cap)
    )


def _probability_prepass(compact: jnp.ndarray, cfg: CodecConfig,
                         primed: bool = False, rstmap=None):
    """Per-decision coding probabilities without materializing the model.

    For each lane: stable-sort decisions by context index (padding sorts
    last), walk the 128-state machine through each context's bit run with a
    one-byte carry (segment boundaries reset to state 0 — fresh context —
    or, when ``primed``, to the substate's prior tables.PRIOR_SUB), then
    scatter the probabilities back to stream order.
    """
    S, cap = compact.shape
    flat = compact.reshape(-1)
    lane_off = (jnp.arange(S) * cap)[:, None]

    key = jnp.where(compact >= 0, compact >> 1, jnp.int32(1 << 22))
    order = jnp.argsort(key, axis=1, stable=True)            # [S, cap]
    sortedp = flat[(lane_off + order).reshape(-1)].reshape(S, cap)

    skey = jnp.where(sortedp >= 0, sortedp >> 1, -1)
    sbit = (sortedp & 1).astype(jnp.int32)
    prev = jnp.concatenate(
        [jnp.full((S, 1), -2, jnp.int32), skey[:, :-1]], axis=1
    )
    seg_start = skey != prev
    if rstmap is not None:  # stored-seed reset map (container flag bit 1)
        rst = jnp.asarray(rstmap)[jnp.clip(skey, 0, cfg.num_states - 1)]
    elif primed:
        rst = jnp.asarray(tables.prior_full(cfg.num_states, cfg.substates))[
            jnp.clip(skey, 0, cfg.num_states - 1)
        ]
    else:
        rst = jnp.zeros(skey.shape, jnp.uint8)

    def walk(state, xs):
        b, ss, r = xs
        st = jnp.where(ss, r.astype(jnp.int32), state.astype(jnp.int32))
        p = transform.STATE_PROB[st]
        ns = transform.NEXT_STATE[st * 2 + b].astype(jnp.uint8)
        return ns, p.astype(jnp.uint8)

    _, probs_sorted = jax.lax.scan(
        walk, jnp.zeros((S,), jnp.uint8), (sbit.T, seg_start.T, rst.T)
    )                                                        # [cap, S]

    # un-permute: probs[lane, order[lane, j]] = probs_sorted[j, lane]
    probs = (
        jnp.zeros((S * cap,), jnp.uint8)
        .at[(lane_off + order).reshape(-1)]
        .set(probs_sorted.T.reshape(-1))
        .reshape(S, cap)
    )
    return probs


def _pipeline_impl(imgs: jnp.ndarray, cap: int, cfg: CodecConfig = REV2,
                   primed: bool = False, rstmap=None):
    """Full model-free encode; ``cap`` = static scan length (bucketed).

    Pure function (unjitted) so ``parallel`` can wrap it in shard_map with
    per-device lane blocks; ``_pipeline`` below is the jitted single-device
    entry point.  ``rstmap`` (optional [num_states] u8) overrides the
    context-reset states (stored-seed containers, flag bit 1).
    """
    S = imgs.shape[0]
    compact = _compact_decisions(imgs, cap, cfg)
    probs = _probability_prepass(compact, cfg, primed, rstmap)

    def step(cod, xs):
        p, prob = xs
        valid_s = p >= 0
        return coder.put_step(cod, (prob.astype(jnp.int32), p & 1, valid_s))

    cod, (meta, runs) = jax.lax.scan(
        step, coder.encoder_init(S), (compact.T, probs.T)
    )
    fmeta, fruns = coder.finish_steps(cod)
    meta = jnp.concatenate([meta, fmeta])
    runs = jnp.concatenate([runs, fruns])
    return meta, runs


_pipeline = jax.jit(_pipeline_impl, static_argnames=("cap", "cfg", "primed"))


def _outcap(n_sym: int) -> int:
    """Per-lane compressed-size bound, bucketed (raw + raw/2 + 64)."""
    return -(-(n_sym + n_sym // 2 + 64) // 1024) * 1024


#: device bytes the GPU engine may hold per call; larger lane batches are
#: encoded in chunks of whole programs
GPU_BATCH_BYTES = 4 << 30
#: the same bound for the XLA engine, whose sort and scans hold about 24
#: bytes per symbol per lane
XLA_BATCH_BYTES = 500_000_000


def _lane_chunks(S: int, per_lane: int, budget: int | None = None,
                 quantum: int | None = None) -> list[tuple[int, int]]:
    """Lane ranges of at most ``budget`` bytes (default: the GPU engine's)
    at ``per_lane`` bytes each, in multiples of ``quantum`` lanes (default:
    one GPU program)."""
    if quantum is None:
        from . import kernels

        quantum = kernels.LANES
    budget = GPU_BATCH_BYTES if budget is None else budget
    chunk = max(quantum, budget // max(1, per_lane) // quantum * quantum)
    return [(i, min(S, i + chunk)) for i in range(0, S, chunk)]


def _download_streams(byts, lens, n: int, outcap: int) -> list[bytes]:
    """Device bytes [S, outcap] + lens -> the first ``n`` lanes' streams,
    downloading only the occupied prefix (bucketed to bound recompiles)."""
    lens = np.asarray(lens)
    cap2 = min(outcap, -(-max(1, int(lens[:n].max())) // 4096) * 4096)
    byts = profiling.timed("encode/download", np.asarray, byts[:, :cap2])
    return [byts[s, : lens[s]].tobytes() for s in range(n)]


def _encode_lanes_gpu(imgs: np.ndarray, cfg: CodecConfig, primed: bool,
                      seed, interpret: bool) -> list[bytes]:
    from . import kernels

    S = imgs.shape[0]
    n_sym = int(np.prod(imgs.shape[1:]))
    outcap = _outcap(n_sym)
    row = jnp.asarray(kernels.model_row(cfg, primed, seed))
    # per lane: model, packed precompute and its temporaries, output bytes
    per_lane = 4 * row.shape[0] + 16 * n_sym + outcap
    out: list[bytes] = []
    for a, b in _lane_chunks(S, per_lane):
        dev = profiling.timed("encode/upload", jax.device_put, imgs[a:b])
        byts, lens = profiling.timed(
            "encode/kernel", kernels.encode_device, dev, row,
            outcap=outcap, cfg=cfg, interpret=interpret)
        out.extend(_download_streams(byts, lens, b - a, outcap))
    return out


def _encode_lanes_xla(imgs: np.ndarray, cfg: CodecConfig, primed: bool,
                      seed) -> list[bytes]:
    counts = np.asarray(_count(imgs, cfg))
    cap = _bucket(int(counts.max()))
    rstmap = (jnp.asarray(tables.prior_full_from(seed, cfg.num_states,
                                                 cfg.substates))
              if seed is not None else None)
    meta, runs = _pipeline(imgs, cap, cfg, primed, rstmap)
    return coder.expand_slots_batch(np.asarray(meta), np.asarray(runs))


def encode_lanes(
    imgs: np.ndarray, cfg: CodecConfig = REV2, engine: str = "auto",
    primed: bool = False, seed=None, interpret: bool = False,
) -> list[bytes]:
    """Encode a batch of equal-shaped lanes [S, H, W, C] -> per-lane streams.

    Each returned byte string is a complete headerless rev-2 entropy stream
    (the caller prepends the 6-byte header or records it in a container).
    engine: 'gpu' (the GPU kernel), 'xla', or 'auto' (the platform's
    device engine, ``dispatch.device_engine``).
    primed: start context row h at the hash-bucketed prior
    tables.PRIOR_TAB[h % 121] instead of zeros (sliced-container flag
    bit 0; single-stream reference mode never primes).
    seed: optional [121, 8] u8 per-image bucket table (stored-seed
    containers, flag bit 1): context row h resets to seed[h % 121]
    instead — the whole batch shares one table, so per-image seeds need
    per-image calls (api.compress) while corpus batching pools one seed.
    interpret: run the GPU kernel in the Pallas interpreter (tests).
    """
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    if engine == "auto":
        engine = dispatch.device_engine("encode")
    if engine not in ("gpu", "xla"):
        raise ValueError(f"unknown encode engine {engine!r}")
    dispatch.record("encode", engine, imgs.shape[0])
    if engine == "gpu":
        return _encode_lanes_gpu(imgs, cfg, primed, seed, interpret)
    n_sym = int(np.prod(imgs.shape[1:]))
    out: list[bytes] = []
    for a, b in _lane_chunks(imgs.shape[0], 24 * n_sym, XLA_BATCH_BYTES, 1):
        out.extend(_encode_lanes_xla(imgs[a:b], cfg, primed, seed))
    return out
