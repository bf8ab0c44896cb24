"""Multi-host chunk compression with ordered gather (BASELINE config 5).

The reference has no distributed communication at all (SURVEY §2: no
NCCL/MPI/Gloo — zero network imports).  This is the multi-host layer it
never had: each process filters+compresses the blocks of its contiguous
slice of the global byte stream with its local devices/cores, per-block
compressed sizes and payloads are exchanged with JAX collectives
(multihost_utils.process_allgather → all_gather over the interconnect), and every
process assembles the identical frame in header order.

Frames are bit-identical to the single-process path for every process
count — the multi-host extension of the mesh-invariance contract.  Both
P=1 and the real P=2 collective path are executed in CI:
tests/test_multihost.py spawns two localhost processes over
jax.distributed.initialize (Gloo collectives on the CPU backend) and
asserts their frames equal the single-process compressor's bytes.

Usage (every process calls with the same global metadata):

    frame = compress_chunked_multihost(global_n, my_slice_bytes, opts)

where process p owns global bytes [slice_start(p), slice_start(p+1)) as
returned by process_slice().
"""

from __future__ import annotations

import struct

import numpy as np

from ..chunk import _ENTRY_MEMCPY, choose_block_size
from ..errors import InvalidDataError
from ..format import (
    FLAG_BITSHUFFLE,
    FLAG_SHUFFLE,
    FLAG_SPLIT,
    FORMAT_VERSION,
    HEADER_SIZE,
    Header,
    Shuffle,
)
from ..options import Options


def process_slice(global_n: int, block_size: int, process_id: int,
                  num_processes: int) -> tuple[int, int]:
    """The [start, end) byte range process p owns: contiguous runs of
    whole blocks, remainder blocks to the leading processes."""
    nb = -(-global_n // block_size)
    per = nb // num_processes
    extra = nb % num_processes
    first = process_id * per + min(process_id, extra)
    count = per + (1 if process_id < extra else 0)
    start = min(first * block_size, global_n)
    end = min((first + count) * block_size, global_n)
    return start, end


def _compress_local_blocks(local: bytes, block_size: int, opts: Options):
    """Compress this process's blocks (native pipeline when available)."""
    from .. import chunk as _chunk

    native = _chunk._native_pipeline_codec(opts.codec, opts.level)
    if native is not None:
        from ..native import backend as _nb

        native_codec, depth = native
        payloads, memf = _nb.compress_blocks(
            local, block_size, opts.type_size, int(opts.shuffle),
            native_codec, depth,
        )
        return payloads, memf
    from .. import filters
    from ..codecs.registry import get_codec

    compressor = get_codec(opts.codec)
    payloads, memf = [], []
    for start in range(0, len(local), block_size):
        block = local[start : start + block_size]
        if opts.shuffle == Shuffle.SHUFFLE and opts.type_size > 1:
            shuf = filters.shuffle_bytes(block, opts.type_size).tobytes()
        elif opts.shuffle == Shuffle.BITSHUFFLE and opts.type_size > 1:
            shuf = filters.bit_shuffle(block, opts.type_size).tobytes()
        else:
            shuf = block
        comp = compressor.compress(shuf, opts.level)
        if len(comp) >= len(block):
            payloads.append(bytes(block))
            memf.append(True)
        else:
            payloads.append(comp)
            memf.append(False)
    return payloads, memf


def allgather_payloads(
    payloads: list[bytes], memf: list[bool]
) -> tuple[list[bytes], list[bool]]:
    """Ordered all-gather of per-block compressed payloads across processes.

    The SURVEY §5 "ordered all-gather of compressed lengths + payloads"
    collective: every process contributes its blocks in local order and
    receives the global list in process order (= header order).  Shared by
    compress_chunked_multihost and dist.mesh.compress_chunked_mesh; the
    P>1 branch is executed by tests/test_multihost.py (2 localhost
    processes, Gloo collectives).
    """
    import jax

    num_processes = jax.process_count()
    if num_processes == 1:
        return list(payloads), list(memf)
    from jax.experimental import multihost_utils

    # 1) gather per-process block counts and sizes (all_gather)
    local_sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    counts = multihost_utils.process_allgather(
        np.array([local_sizes.size], dtype=np.int64)
    ).reshape(-1)
    max_blocks = int(counts.max())
    padded_sizes = np.full(max_blocks, -1, dtype=np.int64)
    padded_sizes[: local_sizes.size] = local_sizes
    padded_memf = np.zeros(max_blocks, dtype=np.int64)
    padded_memf[: local_sizes.size] = np.array(memf, dtype=np.int64)
    sizes_all = multihost_utils.process_allgather(padded_sizes)
    memf_all = multihost_utils.process_allgather(padded_memf)
    # 2) gather payload bytes, padded to the global max payload bytes
    local_blob = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    blob_len = multihost_utils.process_allgather(
        np.array([local_blob.size], dtype=np.int64)
    ).reshape(-1)
    max_blob = int(blob_len.max())
    padded_blob = np.zeros(max_blob, dtype=np.uint8)
    padded_blob[: local_blob.size] = local_blob
    blobs = multihost_utils.process_allgather(padded_blob)
    # 3) ordered reassembly (header order = process order)
    all_payloads: list[bytes] = []
    all_memf: list[bool] = []
    for p in range(num_processes):
        off = 0
        for k in range(int(counts[p])):
            sz = int(sizes_all[p, k])
            all_payloads.append(blobs[p, off : off + sz].tobytes())
            all_memf.append(bool(memf_all[p, k]))
            off += sz
    return all_payloads, all_memf


def compress_chunked_multihost(
    global_n: int, local_data, opts: Options, stats: dict | None = None
) -> bytes:
    """Compress a globally-sharded byte stream into one FLAG_SPLIT frame.

    Every process passes the same ``global_n`` and its own slice (see
    process_slice); all processes return the identical frame.

    ``stats``, when given, receives this process's work-division record —
    local_bytes / local_compress_s (the parallel phase) and gather_s (the
    collective, which includes waiting for stragglers).  This is the
    scaling observability the reference cannot have (no distributed
    layer, SURVEY §5): linear scaling means local_compress_s ≈ the
    single-process time × local_bytes/global_n.
    """
    import time as _time

    import jax

    opts = opts.clamped()
    if global_n <= 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    block_size = choose_block_size(global_n, opts.type_size, opts.block_size)
    num_processes = jax.process_count()
    pid = jax.process_index()
    start, end = process_slice(global_n, block_size, pid, num_processes)
    local = bytes(local_data)
    if len(local) != end - start:
        raise InvalidDataError(
            f"blosc: process {pid} slice is {len(local)} bytes, "
            f"expected {end - start}"
        )

    t0 = _time.perf_counter()
    payloads, memf = _compress_local_blocks(local, block_size, opts)
    t1 = _time.perf_counter()
    all_payloads, all_memf = allgather_payloads(payloads, memf)
    if stats is not None:
        stats.update(
            process=pid,
            num_processes=num_processes,
            local_bytes=len(local),
            global_bytes=global_n,
            local_blocks=len(payloads),
            local_compress_s=t1 - t0,
            gather_s=_time.perf_counter() - t1,
        )

    entries = [
        (len(pl) | (_ENTRY_MEMCPY if m else 0))
        for pl, m in zip(all_payloads, all_memf)
    ]
    num_blocks = len(entries)
    table = struct.pack("<I", num_blocks) + struct.pack(
        f"<{num_blocks}I", *entries
    )
    total = HEADER_SIZE + len(table) + sum(len(p) for p in all_payloads)
    flags = FLAG_SPLIT
    if opts.shuffle == Shuffle.SHUFFLE:
        flags |= FLAG_SHUFFLE
    elif opts.shuffle == Shuffle.BITSHUFFLE:
        flags |= FLAG_BITSHUFFLE
    header = Header(
        version=FORMAT_VERSION,
        version_lz=int(opts.codec),
        flags=flags,
        type_size=min(opts.type_size, 255),
        nbytes_orig=global_n,
        block_size=block_size,
        nbytes_comp=total,
    )
    return header.to_bytes() + table + b"".join(all_payloads)


def decompress_chunked_multihost(frame) -> tuple[bytes, int, int]:
    """Decompress THIS process's slice of a FLAG_SPLIT frame.

    The decode half of the multi-host story: every process receives the
    full frame (frames are the broadcast artifact; they are small), but
    each decodes ONLY the blocks of its contiguous slice — the same
    process_slice partition compress_chunked_multihost uses — so a 4 GB
    chunk decodes with per-host work n/P and zero cross-host traffic.

    Returns (local_bytes, start, end): the decoded slice and its global
    byte range.  With one process this is simply (decompress(frame), 0, n).
    """
    import jax

    from .. import chunk as _chunk
    from ..format import parse_header

    raw = bytes(frame)
    header = parse_header(raw)
    if not header.is_split:
        from ..api import decompress

        out = decompress(raw)
        return out, 0, len(out)
    entries, offset = _chunk.parse_block_table(raw, header)
    n = header.nbytes_orig
    block_size = header.block_size
    _chunk._validate_block_layout(n, block_size, len(entries))

    start, end = process_slice(
        n, block_size, jax.process_index(), jax.process_count()
    )
    first_blk = start // block_size
    last_blk = -(-end // block_size)  # exclusive
    if first_blk >= last_blk:
        return b"", start, start

    # re-frame just the local blocks as a valid FLAG_SPLIT frame and
    # reuse the whole-chunk native decoder (no per-block Python loop)
    local_entries = entries[first_blk:last_blk]
    sizes = [s for s, _ in entries]
    pay_start = offset + sum(sizes[:first_blk])
    pay_end = pay_start + sum(sizes[first_blk:last_blk])
    table = struct.pack("<I", len(local_entries)) + struct.pack(
        f"<{len(local_entries)}I",
        *[
            (s | (_ENTRY_MEMCPY if m else 0))
            for s, m in local_entries
        ],
    )
    local_n = end - start
    sub_header = Header(
        version=header.version,
        version_lz=header.version_lz,
        flags=header.flags,
        type_size=header.type_size,
        nbytes_orig=local_n,
        block_size=block_size,
        nbytes_comp=HEADER_SIZE + len(table) + (pay_end - pay_start),
    )
    sub = sub_header.to_bytes() + table + raw[pay_start:pay_end]
    from ..api import decompress

    return decompress(sub), start, end
