"""Worker process for the real multi-process jax.distributed test.

Launched by tests/test_distributed.py::test_multiprocess_pod_gather with
    python tests/mp_worker.py <coordinator> <nprocs> <pid> <outfile>
Each process gets 4 virtual CPU devices, initializes jax.distributed against
a localhost coordinator, runs compress_image_pod (which executes
_allgather_streams' multi-process gather branch), and writes the container
bytes to <outfile>.  Both ranks must produce identical bytes.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402,F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coordinator, nprocs, pid, outfile = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    height = int(sys.argv[5]) if len(sys.argv) > 5 else 32
    from llcomp_jax import distributed

    distributed.initialize(coordinator, nprocs, pid)
    assert jax.process_count() == nprocs, jax.process_count()

    import numpy as np

    from tests.conftest import make_photo

    img = make_photo(height, 16, seed=3)
    blob = distributed.compress_image_pod(img, slice_h=8)
    with open(outfile, "wb") as f:
        f.write(blob)

    # every rank decodes the assembled container too
    from llcomp_jax import api

    out = api.decompress(blob)
    assert np.array_equal(out, img), "pod container did not round-trip"


if __name__ == "__main__":
    main()
