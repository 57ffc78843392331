"""Device-mesh parallel encode/decode (pjit over a 1-D lane mesh).

The codec's unit of parallelism is the independent stream (SURVEY §7): every
stage of the pipeline — precompute, decision scan, slot emission, symbol
scan — is a pure map over the lane axis, so sharding the batch over a
``jax.sharding.Mesh`` partitions the whole program with **zero collectives**:
each device runs its lanes' scans locally; only the host-side gather of
variable-length byte streams touches the results, and that is an ordered
concatenation by slice index (the container records per-slice lengths).

Multi-host: each process feeds its local lanes
(`jax.make_array_from_process_local_data`), runs the same jit, and
contributes its streams to the container in slice order — the constant
tables are jit constants, broadcast once at compile time.

Scaling model (vs the reference's single thread, `llcomp.hpp:390-448`):
throughput = lanes_in_flight / lockstep_step_time, so efficiency stays ~1.0
as long as every device has enough lanes to fill — which is why
``pick_slice_height`` targets many more stripes than devices.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import coder, container
from . import decode as jdecode
from . import encode as jencode
from .core import tables, transform
from .core.config import REV2, CodecConfig

LANE_AXIS = "lanes"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (LANE_AXIS,))


def _pad_lanes(n: int, n_dev: int) -> int:
    return -(-n // n_dev) * n_dev


def _mesh_platform(mesh: Mesh) -> str:
    return next(iter(mesh.devices.flat)).platform


@functools.lru_cache(maxsize=64)
def _gpu_encode_shard_fn(mesh: Mesh, outcap: int, cfg: CodecConfig,
                         interpret: bool):
    """Cached jitted shard_map of the GPU encode kernel: each device
    encodes its own lane block, zero collectives.  The model row is a
    replicated operand so seeded tables do not key the cache."""
    from . import kernels

    def _shard(x, row):
        return kernels.encode_device(x, row, outcap=outcap, cfg=cfg,
                                     interpret=interpret)

    return jax.jit(
        jax.shard_map(
            _shard, mesh=mesh,
            in_specs=(P(LANE_AXIS), P()),
            out_specs=(P(LANE_AXIS), P(LANE_AXIS)),
            check_vma=False,
        )
    )


def _pad_to_mesh(lanes: np.ndarray, n_dev: int) -> np.ndarray:
    """Pad the lane axis to a multiple of the device count with copies of
    lane 0; padded outputs are dropped."""
    S = lanes.shape[0]
    Sp = _pad_lanes(S, n_dev)
    if Sp == S:
        return lanes
    return np.concatenate([lanes, np.repeat(lanes[:1], Sp - S, axis=0)])


def encode_lanes_sharded(
    lanes: np.ndarray, mesh: Mesh, cfg: CodecConfig = REV2,
    primed: bool = False, seed=None, engine: str = "auto",
    interpret: bool = False,
) -> list[bytes]:
    """Encode equal-shaped lanes [S, H, W, C], sharded over the mesh lane
    axis.  ``seed``: optional [121, 8] stored-seed table (flag bit 1),
    replicated to every device.

    ``engine``: "auto" runs the mesh platform's device engine
    (``dispatch.device_engine``): the GPU kernel per device on a GPU mesh,
    the XLA scan on a CPU mesh; "gpu"/"xla" force one.  ``interpret`` runs
    the GPU kernel in the Pallas interpreter (tests)."""
    from . import dispatch

    if engine == "auto":
        engine = dispatch.device_engine("encode", _mesh_platform(mesh))
    dispatch.record("encode", engine, lanes.shape[0])
    S = lanes.shape[0]
    lanes = _pad_to_mesh(np.ascontiguousarray(lanes, dtype=np.uint8),
                         mesh.devices.size)
    sh_in = NamedSharding(mesh, P(LANE_AXIS))
    dev_lanes = jax.device_put(lanes, sh_in)
    if engine == "gpu":
        from . import kernels

        n_sym = int(np.prod(lanes.shape[1:]))
        outcap = jencode._outcap(n_sym)
        fn = _gpu_encode_shard_fn(mesh, outcap, cfg, interpret)
        byts, lens = fn(dev_lanes, kernels.model_row(cfg, primed, seed))
        return jencode._download_streams(byts, lens, S, outcap)
    if engine != "xla":
        raise ValueError(f"unknown encode engine {engine!r}")
    counts = np.asarray(jencode._count(dev_lanes, cfg))
    cap = jencode._bucket(int(counts.max()))
    rstmap = (None if seed is None else
              np.asarray(tables.prior_full_from(seed, cfg.num_states,
                                                cfg.substates)))

    fn = _scan_shard_fn(mesh, cap, cfg, primed, rstmap is not None)
    meta, runs = fn(dev_lanes, np.zeros(1, np.int32) if rstmap is None
                    else rstmap)
    return coder.expand_slots_batch(np.asarray(meta), np.asarray(runs))[:S]


@functools.lru_cache(maxsize=64)
def _scan_shard_fn(mesh: Mesh, cap: int, cfg: CodecConfig, primed: bool,
                   has_rst: bool):
    """Cached jitted shard_map for the XLA-scan path: every device runs
    the full scan on its own lane block with purely local flat indexing —
    zero collectives by construction (the SPMD partitioner cannot prove
    locality of the flat model gathers itself)."""

    def _shard(x, rst):
        return jencode._pipeline_impl(x, cap, cfg, primed,
                                      rst if has_rst else None)

    return jax.jit(
        jax.shard_map(
            _shard, mesh=mesh,
            in_specs=(P(LANE_AXIS), P()),
            out_specs=(P(None, LANE_AXIS), P(None, LANE_AXIS)),
            check_vma=False,  # constant-seeded scan carries vary over lanes
        )
    )


@functools.lru_cache(maxsize=64)
def _decode_shard_fn(mesh: Mesh, H: int, W: int, C: int, cfg: CodecConfig,
                     primed: bool, has_rst: bool):
    def _shard(x, rst):
        return jdecode._decode_impl(x, H, W, C, cfg, primed,
                                    rst if has_rst else None)

    return jax.jit(
        jax.shard_map(
            _shard, mesh=mesh,
            in_specs=(P(LANE_AXIS), P()),
            out_specs=(P(LANE_AXIS), P(LANE_AXIS)),
            check_vma=False,  # constant-seeded scan carries vary over lanes
        )
    )


@functools.lru_cache(maxsize=64)
def _gpu_decode_shard_fn(mesh: Mesh, H: int, W: int, C: int,
                         cfg: CodecConfig, interpret: bool):
    from . import kernels

    def _shard(x, row):
        return kernels.decode_device(x, row, H, W, C, cfg=cfg,
                                     interpret=interpret)

    return jax.jit(
        jax.shard_map(
            _shard, mesh=mesh,
            in_specs=(P(LANE_AXIS), P()),
            out_specs=(P(LANE_AXIS), P(LANE_AXIS)),
            check_vma=False,
        )
    )


def decode_lanes_sharded(
    streams: list[bytes], shape: tuple[int, int, int], mesh: Mesh,
    cfg: CodecConfig = REV2, primed: bool = False, seed=None,
    engine: str = "auto", interpret: bool = False,
) -> np.ndarray:
    """Decode equal-geometry streams sharded over the mesh lane axis.

    ``engine``: "auto" runs the mesh platform's device engine (the GPU
    kernel on a GPU mesh, the XLA decision engine on a CPU mesh);
    "gpu"/"decision" force one."""
    from . import dispatch

    if engine == "auto":
        engine = dispatch.device_engine("decode", _mesh_platform(mesh))
    dispatch.record("decode", engine, len(streams))
    H, W, C = shape
    S = len(streams)
    n_dev = mesh.devices.size
    Sp = _pad_lanes(S, n_dev)
    cap = jdecode._bucket_cap(max((len(s) for s in streams), default=0))
    sh_in = NamedSharding(mesh, P(LANE_AXIS))
    dev = jax.device_put(jdecode._pack_streams(streams, cap, Sp), sh_in)
    if engine == "gpu":
        from . import kernels

        fn = _gpu_decode_shard_fn(mesh, H, W, C, cfg, interpret)
        imgs, err = fn(dev, kernels.model_row(cfg, primed, seed))
    elif engine == "decision":
        rstmap = (None if seed is None else
                  np.asarray(tables.prior_full_from(seed, cfg.num_states,
                                                    cfg.substates)))
        fn = _decode_shard_fn(mesh, H, W, C, cfg, primed,
                              rstmap is not None)
        planes, err = fn(dev, np.zeros(1, np.int32) if rstmap is None
                         else rstmap)
        imgs = transform.rct_inverse(planes)
    else:
        raise ValueError(f"unknown decode engine {engine!r}")
    err = np.asarray(err)[:S]
    if err.any():
        raise ValueError(
            f"corrupt stream in lanes {np.nonzero(err)[0].tolist()}"
        )
    return np.asarray(imgs)[:S]


def compress_sharded(
    img: np.ndarray, mesh: Mesh, slices: int | str = "auto", cfg: CodecConfig = REV2
) -> bytes:
    """Sliced-container compress with stripes sharded over the mesh.

    Mirrors ``api.compress`` policy: ultra-wide images are column-tiled
    (flag bit 3, ``api.pick_tiling``), so a mesh host and a single-device
    host shape identical containers for the same geometry when both use
    the auto policies (tiling is geometry-pure; the mesh-targeted stripe
    count below only applies untiled, and equals the single-device count
    on four devices).
    """
    from . import api

    img = api._as_image(img)
    H, W, C = img.shape
    tile_w = 0
    if slices == "auto":
        tile_w, slice_h = api.pick_tiling(H, W, C)
        if not tile_w:
            slice_h = api.pick_slice_height(
                H, W, C, target_lanes=8 * mesh.devices.size)
    else:
        slice_h = max(1, -(-H // int(slices)))
    regions = container.tile_regions(W, H, slice_h, tile_w)
    primed = len(regions) > 1 and api._pick_primed(img, cfg)
    seed_tab = seed_blob = None
    if primed and H * W * C >= 120_000:  # same auto policy as api.compress
        from . import seed as seedmod

        seed_tab = seedmod.derive(img, cfg)
        seed_blob = seedmod.pack_blob(seed_tab)

    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, (y0, y1, x0, x1) in enumerate(regions):
        by_shape.setdefault((y1 - y0, x1 - x0), []).append(i)
    out: list[bytes] = [b""] * len(regions)
    for (rows, cols), idxs in by_shape.items():
        stack = np.stack([img[regions[i][0] : regions[i][1],
                              regions[i][2] : regions[i][3]] for i in idxs])
        for i, blob in zip(
            idxs, encode_lanes_sharded(stack, mesh, cfg, primed, seed_tab)
        ):
            out[i] = blob
    return container.pack_sliced(
        out, W, H, C, slice_h, cfg,
        flags=(container.FLAG_SEEDED if seed_tab is not None
               else (container.FLAG_PRIMED if primed else 0))
        | container.FLAG_CRC,
        seed_blob=seed_blob, tile_w=tile_w,
    )


def decompress_sharded(data: bytes, mesh: Mesh, cfg: CodecConfig = REV2) -> np.ndarray:
    (streams, W, H, C, slice_h, flags, seed_blob,
     tile_w) = container.unpack_sliced(data, cfg)
    seed_tab = None
    if seed_blob is not None:
        from . import seed as seedmod

        seed_tab = seedmod.unpack_blob(seed_blob)
    primed = bool(flags & (container.FLAG_PRIMED | container.FLAG_SEEDED))
    regions = container.tile_regions(W, H, slice_h, tile_w)
    out = np.empty((H, W, C), dtype=np.uint8)
    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, (y0, y1, x0, x1) in enumerate(regions):
        by_shape.setdefault((y1 - y0, x1 - x0), []).append(i)
    for (rows, cols), idxs in by_shape.items():
        lanes = decode_lanes_sharded(
            [streams[i] for i in idxs], (rows, cols, C), mesh, cfg, primed,
            seed_tab,
        )
        for k, i in enumerate(idxs):
            y0, y1, x0, x1 = regions[i]
            out[y0:y1, x0:x1] = lanes[k]
    return out
