"""Device-mesh block sharding: the multi-chip/multi-host compress pipeline.

The reference is a single-process library with no parallelism beyond SIMD
(SURVEY §2: NumThreads reserved-but-unused, blosc.go:233; no network code).
This module is the multi-device scaling layer it never had: chunked frames
(chunk.py) already split data into independent blocks, and blocks are the
data-parallel unit:

    host bytes ──split──▶ (nb, bs) uint8 ──shard over mesh axis "blocks"──▶
    per-device shard_map: shuffle/bitshuffle filter (+ stats psum)  ──▶
    per-host codec on its local shard (native OpenMP pipeline)      ──▶
    ordered gather of per-block payloads ──▶ frame assembly on host 0

Design rules (scaling-book recipe): pick a mesh, annotate shardings, let
XLA insert collectives.  The filter step is elementwise-per-block so the
only collectives are the metadata psum/all_gather at the end; they ride
the device interconnect, and frames are bit-identical regardless of mesh shape
("mesh-invariance" — the distributed analogue of the reference's
SIMD-vs-generic equality tests, SURVEY §4).

Multi-host: call initialize_distributed() first (wraps
jax.distributed.initialize); each process compresses the blocks of its
addressable shard and per-block payloads are exchanged with
process_allgather.  On one host every code path below works unchanged.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_shard_map = getattr(jax, "shard_map", None)
if _shard_map is None:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _shard_map

from ..chunk import (
    _ENTRY_MEMCPY,
    choose_block_size,
    parse_block_table,
)
from ..codecs.registry import get_codec
from ..errors import InvalidCodecError, InvalidDataError, SizeMismatchError
from ..filters import batched as fb
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

BLOCK_AXIS = "blocks"


def initialize_distributed(**kwargs) -> None:
    """Bootstrap multi-host JAX (≙ the NCCL/MPI init other frameworks need).

    Safe to skip on a single host.  kwargs pass through to
    jax.distributed.initialize (coordinator_address, num_processes,
    process_id).
    """
    jax.distributed.initialize(**kwargs)


def block_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D device mesh over which blocks are data-parallel."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


def _filter_fn(mode: Shuffle):
    if mode == Shuffle.SHUFFLE:
        return fb._shuffle_batch_dev
    if mode == Shuffle.BITSHUFFLE:
        return fb._bit_shuffle_batch_dev
    return None


def _unfilter_fn(mode: Shuffle):
    if mode == Shuffle.SHUFFLE:
        return fb._unshuffle_batch_dev
    if mode == Shuffle.BITSHUFFLE:
        return fb._bit_unshuffle_batch_dev
    return None


@partial(jax.jit, static_argnums=(1,), static_argnames=("mesh",))
def _apply_sharded_words(x: jax.Array, fn, mesh: Mesh) -> jax.Array:
    """Shard a (nb, words-per-block) word batch over the block axis and
    apply a SWAR filter kernel per row (no communication; see
    filters/batched._SWAR_SHUFFLE — word kernels beat the byte-granular
    ones, and the host u8<->word views are free)."""
    sharding = NamedSharding(mesh, P(BLOCK_AXIS, None))
    x = jax.lax.with_sharding_constraint(x, sharding)
    return jax.lax.with_sharding_constraint(fn(x), sharding)


@partial(jax.jit, static_argnums=(1, 2), static_argnames=("mesh",))
def _filter_sharded(
    x: jax.Array, type_size: int, mode: Shuffle, mesh: Mesh
) -> jax.Array:
    """Filter a (nb, bs) batch sharded over the block axis.

    The op is per-row, so sharding the batch axis needs no communication;
    XLA compiles one program per device under this NamedSharding.
    """
    fn = _filter_fn(mode)
    sharding = NamedSharding(mesh, P(BLOCK_AXIS, None))
    x = jax.lax.with_sharding_constraint(x, sharding)
    y = fn(x, type_size)
    return jax.lax.with_sharding_constraint(y, sharding)


@partial(jax.jit, static_argnums=(1, 2), static_argnames=("mesh",))
def _unfilter_sharded(
    x: jax.Array, type_size: int, mode: Shuffle, mesh: Mesh
) -> jax.Array:
    fn = _unfilter_fn(mode)
    sharding = NamedSharding(mesh, P(BLOCK_AXIS, None))
    x = jax.lax.with_sharding_constraint(x, sharding)
    y = fn(x, type_size)
    return jax.lax.with_sharding_constraint(y, sharding)


def _pad_batch(nb: int, n_shards: int) -> int:
    """Blocks per shard after padding the batch axis to divide evenly."""
    return -(-nb // n_shards)


def filter_blocks_sharded(
    arr: np.ndarray,
    type_size: int,
    mode: Shuffle,
    mesh: Mesh | None = None,
) -> np.ndarray:
    """Filter (nb, bs) blocks across the mesh; bit-identical to the host path.

    Pads the batch axis up to a multiple of the mesh size (padding rows are
    dropped on return), shards rows over the block axis, filters on device.
    """
    if mode == Shuffle.NOSHUFFLE or type_size <= 1:
        return np.asarray(arr)
    if mesh is None:
        mesh = block_mesh()
    nb, bs = arr.shape
    n_shards = mesh.devices.size
    per = _pad_batch(nb, n_shards)
    padded = per * n_shards
    if padded != nb:
        arr = np.concatenate(
            [arr, np.zeros((padded - nb, bs), dtype=np.uint8)], axis=0
        )
    sharding = NamedSharding(mesh, P(BLOCK_AXIS, None))
    w, fn = _swar_route(arr, type_size, mode, fb._SWAR_SHUFFLE,
                        fb._SWAR_BIT_SHUFFLE)
    if w is not None:
        x = jax.device_put(w, sharding)
        y = _apply_sharded_words(x, fn, mesh=mesh)
        return np.asarray(y).view(np.uint8)[:nb]
    x = jax.device_put(arr, sharding)
    y = _filter_sharded(x, type_size, mode, mesh=mesh)
    return np.asarray(y)[:nb]


def _swar_route(arr, type_size, mode, byte_tbl, bit_tbl):
    """Pick the SWAR word kernel + free host word view for this filter
    mode, or (None, None) when only the byte-granular path applies."""
    if mode == Shuffle.SHUFFLE and type_size in byte_tbl:
        return fb._word_view(np.ascontiguousarray(arr), type_size), byte_tbl[
            type_size
        ]
    if mode == Shuffle.BITSHUFFLE and type_size in bit_tbl:
        fn, quant = bit_tbl[type_size]
        return fb._view_as(
            np.ascontiguousarray(arr), np.uint32, quant
        ), fn
    return None, None


def unfilter_blocks_sharded(
    arr: np.ndarray,
    type_size: int,
    mode: Shuffle,
    mesh: Mesh | None = None,
) -> np.ndarray:
    if mode == Shuffle.NOSHUFFLE or type_size <= 1:
        return np.asarray(arr)
    if mesh is None:
        mesh = block_mesh()
    nb, bs = arr.shape
    n_shards = mesh.devices.size
    per = _pad_batch(nb, n_shards)
    padded = per * n_shards
    if padded != nb:
        arr = np.concatenate(
            [arr, np.zeros((padded - nb, bs), dtype=np.uint8)], axis=0
        )
    sharding = NamedSharding(mesh, P(BLOCK_AXIS, None))
    w, fn = _swar_route(arr, type_size, mode, fb._SWAR_UNSHUFFLE,
                        fb._SWAR_BIT_UNSHUFFLE)
    if w is not None:
        x = jax.device_put(w, sharding)
        y = _apply_sharded_words(x, fn, mesh=mesh)
        return np.asarray(y).view(np.uint8)[:nb]
    x = jax.device_put(arr, sharding)
    y = _unfilter_sharded(x, type_size, mode, mesh=mesh)
    return np.asarray(y)[:nb]


# ---------------------------------------------------------------------------
# end-to-end chunked frame compress/decompress over a mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshStats:
    """Cross-chip metadata from the sharded filter step.

    ``histogram`` is the psum-reduced byte histogram of a UNIFORM CHUNK
    SAMPLE of the filtered stream (entropy proxy, same signal
    suggest_codec uses) covering ``sample_bytes`` bytes — at most
    ~_HIST_CAP per device: a full-stream scatter histogram costs far
    more than the filter work it describes, and the statistic is an
    advisory proxy.  When the shard fits under the cap the sample IS the
    full stream.
    ``block_diffs`` is the all_gathered per-block count of bytes
    differing from their predecessor (run-structure proxy) in header
    order, exact.  Both are explicit collectives inside the
    shard_map step.
    """

    histogram: np.ndarray
    block_diffs: np.ndarray
    sample_bytes: int = 0


#: histogram sampling: 512-byte chunks, at most ~256 KiB per device
_HIST_CHUNK = 512
_HIST_CAP = 256 << 10


def _hist_stride(n_chunks: int) -> int:
    return max(1, n_chunks // (_HIST_CAP // _HIST_CHUNK))


def _hist_sample_accounting(
    n_shards: int, per: int, block_size: int, nb_full: int
) -> tuple[int, int]:
    """(total sampled bytes, sampled bytes that fall in zero padding
    rows) for the step's per-device chunk sampling — same static layout
    the traced step uses."""
    shard_bytes = per * block_size
    sample = pad = 0
    for d in range(n_shards):
        real_b = max(0, min(nb_full - d * per, per)) * block_size
        if shard_bytes % _HIST_CHUNK:
            sample += shard_bytes
            pad += shard_bytes - real_b
            continue
        nch = shard_bytes // _HIST_CHUNK
        starts = np.arange(0, nch, _hist_stride(nch)) * _HIST_CHUNK
        sample += starts.size * _HIST_CHUNK
        pad += int(
            np.clip(starts + _HIST_CHUNK - real_b, 0, _HIST_CHUNK).sum()
        )
    return sample, pad


_filter_step_cache: dict = {}


def _mesh_filter_step(mesh: Mesh, type_size: int, mode: Shuffle):
    """Jitted shard_map step: per-device filter + explicit collectives.

    Each device filters its local (per, bs) rows, then contributes to a
    psum'd byte histogram and an ordered all_gather of per-block diff
    counts — the same collective pattern the multi-host frame assembly
    uses for compressed lengths (SURVEY §5), here in the production path.
    """
    key = (mesh, type_size, mode)
    fn = _filter_step_cache.get(key)
    if fn is not None:
        return fn

    filt = _filter_fn(mode)

    def step(x):
        y = filt(x, type_size) if filt is not None else x
        if y.size % _HIST_CHUNK == 0:
            ch = y.reshape(-1, _HIST_CHUNK)
            stride = _hist_stride(ch.shape[0])
            samp = ch[::stride].reshape(-1)  # major-dim stride: cheap
        else:  # odd geometry: exact histogram (such shards are small)
            samp = y.reshape(-1)
        hist = jnp.zeros((256,), jnp.int32).at[samp].add(1)
        hist = jax.lax.psum(hist, BLOCK_AXIS)
        diffs = (y[:, 1:] != y[:, :-1]).sum(axis=1, dtype=jnp.int32)
        diffs = jax.lax.all_gather(diffs, BLOCK_AXIS, tiled=True)
        return y, hist, diffs

    fn = jax.jit(
        _shard_map(
            step,
            mesh=mesh,
            in_specs=P(BLOCK_AXIS, None),
            out_specs=(P(BLOCK_AXIS, None), P(), P()),
            # all_gather output is value-replicated but vma inference can't
            # see that; mesh-invariance tests check the actual values
            check_vma=False,
        )
    )
    _filter_step_cache[key] = fn
    return fn


def compress_chunked_mesh(
    data,
    opts: Options,
    mesh: Mesh | None = None,
    return_stats: bool = False,
):
    """Compress into a FLAG_SPLIT frame with the filter stage on the mesh.

    Bit-identical to chunk.compress_chunked for every mesh shape (the codec
    stage is deterministic per block and blocks are reassembled in header
    order).  The device stage is an explicit shard_map with psum +
    all_gather collectives (see _mesh_filter_step); the payload exchange
    goes through multihost.allgather_payloads — the ordered gather that
    tests/test_multihost.py executes with 2 real processes.

    With ``return_stats`` the cross-chip MeshStats are returned alongside
    the frame.
    """
    if isinstance(data, np.ndarray):
        raw = data.tobytes()
    else:
        raw = bytes(data)
    opts = opts.clamped()
    compressor = get_codec(opts.codec)
    if compressor is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {opts.codec}")
    if mesh is None:
        mesh = block_mesh()

    n = len(raw)
    if n == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    block_size = choose_block_size(n, opts.type_size, opts.block_size)
    nb_full = n // block_size
    tail = raw[nb_full * block_size :]

    # device-sharded filter of the full blocks (explicit collectives)
    filtered: list[bytes] = []
    stats = None
    if nb_full:
        arr = np.frombuffer(
            raw[: nb_full * block_size], dtype=np.uint8
        ).reshape(nb_full, block_size)
        n_shards = mesh.devices.size
        per = _pad_batch(nb_full, n_shards)
        padded = per * n_shards
        if padded != nb_full:
            arr = np.concatenate(
                [arr, np.zeros((padded - nb_full, block_size), np.uint8)]
            )
        x = jax.device_put(arr, NamedSharding(mesh, P(BLOCK_AXIS, None)))
        use_filter = opts.shuffle != Shuffle.NOSHUFFLE and opts.type_size > 1
        step = _mesh_filter_step(
            mesh, opts.type_size, opts.shuffle if use_filter else Shuffle.NOSHUFFLE
        )
        y, hist, diffs = step(x)
        shuffled = np.asarray(y)[:nb_full]
        hist_np = np.asarray(hist).copy()
        # padding rows are all-zero; remove their sampled contribution so
        # the histogram covers real bytes only (mirror of the step's
        # static chunk-sampling layout, per device shard)
        sample_bytes, pad_bytes = _hist_sample_accounting(
            n_shards, per, block_size, nb_full
        )
        hist_np[0] -= pad_bytes
        stats = MeshStats(
            histogram=hist_np,
            block_diffs=np.asarray(diffs)[:nb_full],
            sample_bytes=sample_bytes - pad_bytes,
        )
        filtered = [shuffled[i].tobytes() for i in range(nb_full)]
    if tail:
        from .. import filters as host_filters

        if opts.shuffle == Shuffle.SHUFFLE and opts.type_size > 1:
            filtered.append(
                host_filters.shuffle_bytes(tail, opts.type_size).tobytes()
            )
        elif opts.shuffle == Shuffle.BITSHUFFLE and opts.type_size > 1:
            filtered.append(
                host_filters.bit_shuffle(tail, opts.type_size).tobytes()
            )
        else:
            filtered.append(tail)

    # per-host codec stage over this process's contiguous block slice,
    # then the ordered cross-process payload gather (no-op at P=1; the
    # P>1 branch is executed by tests/test_multihost.py)
    from .multihost import allgather_payloads, process_slice

    nb_total = len(filtered)
    pid = jax.process_index()
    nprocs = jax.process_count()
    lo_byte, hi_byte = process_slice(n, block_size, pid, nprocs)
    lo, hi = lo_byte // block_size, -(-hi_byte // block_size)

    local_payloads: list[bytes] = []
    local_memf: list[bool] = []
    pos = lo * block_size
    for i in range(lo, hi):
        shuf_block = filtered[i]
        raw_block = raw[pos : pos + len(shuf_block)]
        pos += len(shuf_block)
        comp = compressor.compress(shuf_block, opts.level)
        if len(comp) >= len(raw_block):
            local_payloads.append(raw_block)
            local_memf.append(True)
        else:
            local_payloads.append(comp)
            local_memf.append(False)

    payloads, memf = allgather_payloads(local_payloads, local_memf)
    if len(payloads) != nb_total:
        raise InvalidDataError(
            f"blosc: mesh gather returned {len(payloads)} blocks, "
            f"expected {nb_total}"
        )
    entries = [
        (len(p) | (_ENTRY_MEMCPY if m else 0))
        for p, m in zip(payloads, memf)
    ]

    flags = FLAG_SPLIT
    if opts.shuffle == Shuffle.SHUFFLE:
        flags |= FLAG_SHUFFLE
    elif opts.shuffle == Shuffle.BITSHUFFLE:
        flags |= FLAG_BITSHUFFLE

    num_blocks = len(payloads)
    table = struct.pack("<I", num_blocks) + struct.pack(
        f"<{num_blocks}I", *entries
    )
    total = HEADER_SIZE + len(table) + sum(len(p) for p in payloads)
    header = Header(
        version=FORMAT_VERSION,
        version_lz=int(opts.codec),
        flags=flags,
        type_size=min(opts.type_size, 255),
        nbytes_orig=n,
        block_size=block_size,
        nbytes_comp=total,
    )
    frame = header.to_bytes() + table + b"".join(payloads)
    if return_stats:
        return frame, stats
    return frame


def decompress_chunked_mesh(
    data, mesh: Mesh | None = None, type_size: int = 0
) -> bytes:
    """Decompress a FLAG_SPLIT frame with the unfilter stage on the mesh."""
    raw = bytes(data)
    from ..format import parse_header

    header = parse_header(raw)
    if not header.is_split:
        from ..api import decompress_with_size

        return decompress_with_size(raw, type_size)
    if mesh is None:
        mesh = block_mesh()
    entries, offset = parse_block_table(raw, header)
    if type_size <= 0:
        type_size = header.type_size
    n = header.nbytes_orig
    block_size = header.block_size
    if block_size == 0:
        raise InvalidDataError("blosc: invalid compressed data: zero block size")

    decompressor = get_codec(header.codec)
    if decompressor is None and not all(m for _, m in entries):
        raise InvalidCodecError(f"blosc: unsupported codec: {header.codec}")

    # codec stage per block on the host
    mode = header.shuffle_mode
    blocks: list[bytes] = []
    pos = 0
    o = offset
    for i, (psize, is_memcpy) in enumerate(entries):
        if o + psize > header.nbytes_comp or o + psize > len(raw):
            raise InvalidDataError(
                "blosc: invalid compressed data: block payload overruns frame"
            )
        payload = raw[o : o + psize]
        o += psize
        this_block = min(block_size, n - pos)
        if is_memcpy:
            if psize != this_block:
                raise SizeMismatchError(
                    f"blosc: decompressed size mismatch in memcpy block {i}"
                )
            blocks.append((payload, False))
        else:
            dec = decompressor.decompress(payload, this_block)
            if len(dec) != this_block:
                raise SizeMismatchError(
                    f"blosc: decompressed size mismatch: block {i}"
                )
            blocks.append((dec, True))
        pos += this_block

    # device-sharded unfilter of the full filtered blocks
    full = [
        (i, b)
        for i, (b, f) in enumerate(blocks)
        if f and len(b) == block_size and mode != Shuffle.NOSHUFFLE
    ]
    out_blocks: list[bytes] = [None] * len(blocks)
    if full and type_size > 1:
        arr = np.frombuffer(
            b"".join(b for _, b in full), dtype=np.uint8
        ).reshape(len(full), block_size)
        unf = unfilter_blocks_sharded(arr, type_size, mode, mesh)
        for k, (i, _) in enumerate(full):
            out_blocks[i] = unf[k].tobytes()
    from .. import filters as host_filters

    for i, (b, f) in enumerate(blocks):
        if out_blocks[i] is not None:
            continue
        if not f or mode == Shuffle.NOSHUFFLE or type_size <= 1:
            out_blocks[i] = b
        elif mode == Shuffle.BITSHUFFLE:
            out_blocks[i] = host_filters.bit_unshuffle(b, type_size).tobytes()
        else:
            out_blocks[i] = host_filters.unshuffle_bytes(b, type_size).tobytes()

    result = b"".join(out_blocks)
    if len(result) != n:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: got {len(result)}, expected {n}"
        )
    return result
