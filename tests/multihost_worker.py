"""Worker process for the executed multi-host gather test (not a test module).

Launched by tests/test_multihost.py as one of N localhost processes:

    python tests/multihost_worker.py <pid> <nprocs> <port> <out_path>

Each process initializes jax.distributed on CPU, compresses its contiguous
block slice of a deterministic global byte stream through
compress_chunked_multihost (exercising the process_allgather branch for
P>1), and writes the assembled frame to <out_path>.
"""

import sys


def main() -> None:
    pid, nprocs, port, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    import jax

    # the workers stay on the CPU (one jax.distributed process each); the
    # config update must land before any backend use
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )

    import numpy as np

    from tpu_blosc.dist import multihost
    from tpu_blosc.options import Options
    from tpu_blosc.chunk import choose_block_size

    # ~600 KB f32 ramp + a run-heavy tail so memcpy and compressed blocks mix
    ramp = np.arange(140_000, dtype=np.float32).tobytes()
    noise = np.random.default_rng(7).integers(
        0, 256, 40_000, dtype=np.uint8
    ).tobytes()
    data = ramp + noise
    opts = Options(block_size=65536)
    block_size = choose_block_size(len(data), opts.type_size, opts.block_size)
    start, end = multihost.process_slice(len(data), block_size, pid, nprocs)
    stats: dict = {}
    frame = multihost.compress_chunked_multihost(
        len(data), data[start:end], opts, stats=stats
    )
    with open(out_path, "wb") as f:
        f.write(frame)
    import json

    with open(out_path + ".stats.json", "w") as f:
        json.dump(stats, f)

    # decode direction: this process decodes only its slice of the frame
    local, dstart, dend = multihost.decompress_chunked_multihost(frame)
    assert (dstart, dend) == (start, end), (dstart, dend, start, end)
    assert local == data[start:end], "decoded slice mismatch"
    with open(out_path + ".dec", "wb") as f:
        f.write(local)


if __name__ == "__main__":
    main()
