"""Device-resident array compression: jax.Array in, Blosc frame out.

The entry point for compressing data that already lives on an
accelerator (activations, checkpoint shards): the shuffle/bitshuffle
filter runs ON DEVICE over the array's bytes (XLA-compiled word
kernels, filters/batched.py), only the filtered stream is transferred,
and the host runs the codec stage (OpenMP native pipeline).

Frames are BIT-IDENTICAL to ``compress(np.asarray(x).tobytes(), ...)`` —
device filtering is an execution choice, never a format choice — so
everything decodes everywhere (including the reference's own decoder for
single-block frames).

decompress_array is the inverse convenience: decode on host straight into
a pinned buffer and device_put.
"""

from __future__ import annotations

import os

import numpy as np

from . import filters
from .chunk import _ENTRY_MEMCPY, choose_block_size
from .codecs.registry import get_codec
from .errors import InvalidCodecError, InvalidDataError
from .format import (
    FLAG_BITSHUFFLE,
    FLAG_SHUFFLE,
    FLAG_SPLIT,
    FORMAT_VERSION,
    HEADER_SIZE,
    Codec,
    Header,
    Shuffle,
)
from .options import Options


from functools import partial

import jax as _jax


@partial(_jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _device_filter_prep(
    x, nb: int, bs: int, type_size: int, mode: int, u32_ok: bool = False
):
    """One compiled unit: flatten to bytes, filter the full-block prefix,
    return (filtered, tail bytes).  One jit keeps compilation to one
    program per input shape.

    ``filtered`` is (nb, bs) u8 — except when ``u32_ok`` and the input
    dtype's width equals a SWAR-covered type_size (2/4/8) under byte
    shuffle, where it is (nb, bs//2) u16 or (nb, bs//4) u32 carrying the
    SAME byte stream (LE words; caller views as bytes).  The SWAR word
    paths skip every byte-granular relayout: the bitcast is free and the
    byte transpose becomes in-register word SWAR
    (filters/batched._SWAR_SHUFFLE; on an H100 they run at the speed of
    a device copy, the u8 transpose at about two thirds of it — PERF.md).
    Callers that need byte-granular views on device (the match/rle
    segment pipelines) leave u32_ok off."""
    import jax
    import jax.numpy as jnp

    from .filters import batched as fb

    flat = x.reshape(-1)

    def _swar_filter(kern, wdt, wsize):
        """Shared SWAR body: bitcast to words, barrier, kernel, tail.

        The barrier makes XLA materialize the (nb, wpb) word view before
        the SWAR picks instead of fusing the kernel's narrow
        (nb, wpb//4, 4) view into the bitcast."""
        words = jax.lax.bitcast_convert_type(flat, wdt).reshape(-1)
        wpb = bs // wsize
        words2d = jax.lax.optimization_barrier(
            words[: nb * wpb].reshape(nb, wpb)
        )
        tail_w = words[nb * wpb :]
        if tail_w.size:
            tail = jax.lax.bitcast_convert_type(tail_w, jnp.uint8).reshape(-1)
        else:
            tail = jnp.zeros((0,), jnp.uint8)
        return kern(words2d), tail

    if (
        u32_ok
        and mode == int(Shuffle.SHUFFLE)
        and type_size in (2, 4, 8)  # ts=16 has no bitcastable jax dtype
        and flat.dtype.itemsize == type_size
        and bs % {2: 4, 4: 16, 8: 32}[type_size] == 0
    ):
        if type_size == 2:
            # ts=2 stays in same-width u16 words on device: widening the
            # bitcast to u32 would itself be a lane repack (host buffers
            # get the faster u32 ts2 kernel through the free np view)
            return _swar_filter(fb._shuffle_batch_dev_u16, jnp.uint16, 2)
        return _swar_filter(fb._SWAR_SHUFFLE[type_size], jnp.uint32, 4)
    if (
        u32_ok
        and mode == int(Shuffle.BITSHUFFLE)
        and type_size in (4, 8)  # ts=2 would need a widening u16->u32
        # bitcast (an (n, 2) relayout of its own); device ts=2
        # bitshuffle stays on the u8 path, host views stay SWAR
        and flat.dtype.itemsize == type_size
        and bs % fb._SWAR_BIT_SHUFFLE[type_size][1] == 0
    ):
        return _swar_filter(
            fb._SWAR_BIT_SHUFFLE[type_size][0], jnp.uint32, 4
        )
    if flat.dtype != jnp.uint8:
        x_bytes = jax.lax.bitcast_convert_type(flat, jnp.uint8).reshape(-1)
    else:
        x_bytes = flat
    blocks = x_bytes[: nb * bs].reshape(nb, bs)
    if mode == int(Shuffle.SHUFFLE):
        filtered = fb._shuffle_batch_dev(blocks, type_size)
    else:
        filtered = fb._bit_shuffle_batch_dev(blocks, type_size)
    return filtered, x_bytes[nb * bs :]


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _cap_bucket(n: int) -> int:
    """Shape-stable pad cap with <=33% overhead: next of {3*2^(k-2), 2^k}.

    The literal scatter/gather programs pay per PADDED entry, so plain
    pow2 padding wastes up to 2x device time; the extra 3*2^(k-2) bucket
    halves the worst case for one more compile variant per octave (same
    trick as the pow2+3*pow2 offset grid)."""
    p = _pow2(n)
    q = 3 * p // 4
    return q if n <= q else p


@partial(_jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _device_filter_seg_counts(
    x, nb: int, bs: int, type_size: int, mode: int, seg: int
):
    """Filter + per-SEGMENT run counts, where a segment is one byte-plane
    of one block (bs/type_size contiguous bytes) — the natural sparsity
    unit, since block-local shuffling gives every block both run-sparse
    and dense planes.  The (nseg, seg) view stays on device."""
    import jax.numpy as jnp

    filtered, tail = _device_filter_prep(x, nb, bs, type_size, mode)
    segs = filtered.reshape(-1, seg)
    nseg = segs.shape[0]
    row_b = jnp.concatenate(
        [jnp.ones((nseg, 1), bool), segs[:, 1:] != segs[:, :-1]], axis=1
    )
    return segs, row_b.sum(axis=1).astype(jnp.int32), tail


@partial(_jax.jit, static_argnums=(2, 3))
def _device_rows_rle(filtered, rows, k: int, cap: int):
    """Run-length records for the selected rows of a filtered batch.

    ``rows`` is (k,) int32 (pad entries repeat a real row; their records
    trail the real ones and are sliced off by the caller via the known
    per-row counts).  Returns (vals, lens, starts_valid_total).
    """
    import jax.numpy as jnp

    sub = filtered[rows]  # (k, bs) gather
    bs = sub.shape[1]
    row_b = jnp.concatenate(
        [jnp.ones((k, 1), bool), sub[:, 1:] != sub[:, :-1]], axis=1
    )
    flat = sub.reshape(-1)
    b = row_b.reshape(-1)
    total = k * bs
    idx = jnp.nonzero(b, size=cap, fill_value=total)[0]
    vals = flat[jnp.minimum(idx, total - 1)]
    lens = jnp.diff(jnp.concatenate([idx, jnp.array([total])])).astype(
        jnp.int32
    )
    return vals, lens


@partial(_jax.jit, static_argnums=(2,))
def _device_rows_gather(filtered, rows, k: int):
    """Gather selected rows for transfer (dense blocks)."""
    return filtered[rows]


# ---------------------------------------------------------------------------
# fixed-offset match discovery (the dense-segment device codec stage)
# ---------------------------------------------------------------------------

# minimum surviving match-run length: gaps between literal islands are
# >= this, comfortably above LZ4's 4-byte minimum and long enough that a
# (token, offset) pair always undercuts the literals it replaces
_MATCH_T = 8

# forced-literal tail per row keeps emitted streams clear of the LZ4
# end-of-block rules (last 5 literals / no match into the last 12)
_ROW_TAIL_LITERALS = 16


def _match_offsets(seg: int) -> tuple[int, ...]:
    """Candidate match offsets: pow2 AND 3*pow2 strides up to 1024.

    Powers of two cover the periodic structures byte-planes inherit from
    tiled/interleaved numeric data; the 3*pow2 family adds 3-channel
    interleaves and 96-byte-struct pitches (round-2 verdict item: the
    pow2-only model left those with zero benefit).  Divisibility by seg
    is NOT required — the residue reshapes in the reconstruction paths
    pad the row to a multiple of d and slice back.
    """
    return tuple(
        d
        for d in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96,
                  128, 192, 256, 384, 512, 768, 1024)
        if d < seg
    )


def _device_match_pipeline(
    x, nb: int, bs: int, type_size: int, mode: int, seg: int,
    offsets: tuple,
):
    """The device half of the match strategy: filter program + match program.

    Two compiled programs: the filter's transpose intermediates stay out
    of the match program's memory plan, for one extra device round trip
    of the filtered bytes.
    """
    filtered, tail = _device_filter_prep(x, nb, bs, type_size, mode)
    segs, best, lit_counts, packed = _device_match_core(
        filtered, seg, offsets
    )
    return segs, best, lit_counts, packed, tail


@partial(_jax.jit, static_argnums=(1, 2))
def _device_match_core(filtered, seg: int, offsets: tuple):
    """Match discovery over a filtered (nb, bs) batch in ONE program.

    filter → per-row equality counts for every candidate offset (the
    device-side match discovery, ≙ the hash-probe loop of codec.go:63-128
    restructured as data-parallel whole-array compares) → per-row argmax
    offset → literal mask → per-row literal counts → keep mask (records
    beat bytes only below seg/10 literals) → BIT-PACKED literal mask.

    The per-offset passes run inside ``fori_loop``s over a TRACED offset
    array (the shifted view is a fixed-size dynamic_slice of a left-padded
    copy), so the compiled program size is independent of the candidate
    count (20 offsets).

    The mask ships packed (n/8 bytes) and the host extracts positions —
    not compacted on device: a device-side compaction (jnp.nonzero,
    full-size scatter) is a sort, while bit-packing is 8 strided-slice
    shift-ors at memory speed.  Values are fetched by a second gather
    program once the host knows the positions (_device_gather_vals).

    All per-row work runs inside a ``lax.scan`` over row chunks so the
    loop-carried bool eq mask stays bounded (~16 MiB of rows per step)
    whatever the input size.  Rows are independent, so chunking costs
    nothing but the scan trip count.
    """
    import jax
    import jax.numpy as jnp

    segs = filtered.reshape(-1, seg)
    nseg = segs.shape[0]
    dmax = max(offsets)
    offs_arr = jnp.asarray(offsets, jnp.int32)
    col = jnp.arange(seg, dtype=jnp.int32)[None, :]
    rows = _decode_row_chunk(nseg, seg, target_bytes=16 << 20)
    g = nseg // rows

    def _chunk(_, segs_c):
        padded = jnp.concatenate(
            [jnp.zeros((rows, dmax), jnp.uint8), segs_c], axis=1
        )

        def eq_at(d):
            shifted = jax.lax.dynamic_slice(
                padded, (jnp.int32(0), jnp.int32(dmax) - d), (rows, seg)
            )
            return (segs_c == shifted) & (col >= d)

        def _count_body(i, carry):
            best_c, best_i = carry
            c = eq_at(offs_arr[i]).sum(axis=1, dtype=jnp.int32)
            better = c > best_c
            return (
                jnp.where(better, c, best_c),
                jnp.where(better, jnp.int32(i), best_i),
            )

        zero = jnp.zeros((rows,), jnp.int32)
        _, best = jax.lax.fori_loop(
            0, len(offsets), _count_body, (zero, zero)
        )

        def _select_body(i, eq):
            return jnp.where((best == i)[:, None], eq_at(offs_arr[i]), eq)

        eq = jax.lax.fori_loop(
            0, len(offsets), _select_body, jnp.zeros((rows, seg), bool)
        )
        lit = _open_mask(eq, _MATCH_T)
        lit_counts = lit.sum(axis=1, dtype=jnp.int32)
        keep = lit_counts <= seg // 10
        lit = lit & keep[:, None]
        # bit-pack: packed[:, j] bit i = lit[:, 8j+i] (np.unpackbits
        # bitorder='little' inverts on host); strided lane slices, no
        # reshape
        packed = lit[:, 0::8].astype(jnp.uint8)
        for i in range(1, 8):
            packed = packed | (lit[:, i::8].astype(jnp.uint8) << i)
        return None, (best, lit_counts, packed)

    if g == 1:
        _, (best, lit_counts, packed) = _chunk(None, segs)
    else:
        _, (best, lit_counts, packed) = jax.lax.scan(
            _chunk, None, segs.reshape(g, rows, seg)
        )
        best = best.reshape(nseg)
        lit_counts = lit_counts.reshape(nseg)
        packed = packed.reshape(nseg, -1)
    return segs, best, lit_counts, packed


def _unpack_positions(packed_flat: np.ndarray) -> np.ndarray:
    """Set-bit positions of a little-endian bit-packed mask (sorted).

    Sparse-aware: expands only the nonzero mask bytes (a full
    np.unpackbits over n bits costs ~0.7 s at 256 MiB; this is ~0.2 s at
    the typical <20% nonzero-byte density)."""
    nzb = np.flatnonzero(packed_flat)
    if nzb.size == 0:
        return np.empty(0, np.int64)
    bits8 = np.unpackbits(
        packed_flat[nzb][:, None], axis=1, bitorder="little"
    ).astype(bool)
    base = (nzb.astype(np.int64) * 8)[:, None] + np.arange(8, dtype=np.int64)
    return base[bits8]


@_jax.jit
def _device_gather_vals(segs, pos):
    """Fetch literal bytes at host-provided flat positions (small gather)."""
    total = segs.shape[0] * segs.shape[1]
    return segs.reshape(-1)[_jax.numpy.minimum(pos, total - 1)]


@_jax.jit
def _device_gather_vals_delta(segs, du16):
    """_device_gather_vals with the positions shipped as uint16 DELTAS
    and reconstructed by a device cumsum.

    u16 deltas halve the host-to-device position upload; gaps > 65535
    are split by the host into 65535-steps whose intermediate (dummy)
    entries gather a throwaway byte the host discards
    (_delta_encode_positions).  Pad deltas are 0 (re-gather the last
    position) — always in range."""
    import jax.numpy as jnp

    total = segs.shape[0] * segs.shape[1]
    pos = jnp.cumsum(du16.astype(jnp.int32))
    return segs.reshape(-1)[jnp.minimum(pos, total - 1)]


@_jax.jit
def _device_gather_vals_delta_base(segs, du16, base):
    """_device_gather_vals_delta with a scalar flat-position base added —
    the per-chunk form used by _fetch_match_records: each row-group
    chunk's deltas are encoded chunk-relative (small first delta) and the
    chunk's global offset arrives as ``base`` (a 0-d int32, traced so one
    compile serves every chunk)."""
    import jax.numpy as jnp

    total = segs.shape[0] * segs.shape[1]
    pos = base + jnp.cumsum(du16.astype(jnp.int32))
    return segs.reshape(-1)[jnp.minimum(pos, total - 1)]


def _overlap_chunk_rows(mask_row_bytes: int) -> int:
    """Rows per overlap chunk: ~12 MiB of packed mask each (override via
    TPU_BLOSC_OVERLAP_CHUNK_BYTES; tests force tiny chunks).  Each chunk
    costs four transfers and a gather program, so chunks are kept few."""
    chunk_bytes = int(
        os.environ.get("TPU_BLOSC_OVERLAP_CHUNK_BYTES", 12 << 20)
    )
    return max(1, chunk_bytes // max(mask_row_bytes, 1))


def _fetch_match_records(segs_d, packed_d, lit_counts, seg: int, n_real: int):
    """Stage C-E of the match pipeline: packed mask -> (global positions,
    literal bytes), or None on mask disagreement (caller bails to the
    transfer strategy).

    Two execution plans, byte-identical outputs:

    * monolithic (small masks, or TPU_BLOSC_NO_OVERLAP_FETCH /
      TPU_BLOSC_NO_DELTA_POS set): one mask fetch, one position scan, one
      gather — the round-4 flow.
    * chunked-overlap: the mask is fetched in ~12 MiB row-group chunks
      (_overlap_chunk_rows) on a background thread while the main thread
      runs the ctz position scan, delta-encodes, uploads, and dispatches
      the per-chunk value gathers, so host work overlaps the transfers.
      Per-chunk deltas never hit the monolithic path's u16 split blowup:
      within-chunk gaps sum to at most the chunk's bit-span, bounding
      dummy entries at ~1.5k per chunk.

    ``lit_counts`` must already be zeroed for non-sparse rows (their mask
    bytes are zeroed on device), so per-chunk expected counts are plain
    range sums.
    """
    nseg = packed_d.shape[0]
    row_bytes = packed_d.shape[1]
    chunk_rows = _overlap_chunk_rows(row_bytes)
    min_bytes = int(
        os.environ.get("TPU_BLOSC_OVERLAP_FETCH_MIN", 8 << 20)
    )
    use_overlap = (
        not os.environ.get("TPU_BLOSC_NO_OVERLAP_FETCH")
        and not os.environ.get("TPU_BLOSC_NO_DELTA_POS")
        and nseg * row_bytes >= min_bytes
        and nseg > chunk_rows
    )
    if not use_overlap:
        packed = np.asarray(packed_d)
        pos = _nb_mask_positions(packed.reshape(-1), n_real)
        if pos is None or pos.size != n_real:
            return None
        du, dkeep = _delta_encode_positions(pos)
        if du.size <= n_real + n_real // 2 and not os.environ.get(
            "TPU_BLOSC_NO_DELTA_POS"
        ):
            cap = _cap_bucket(max(du.size, 4096))
            du_p = np.zeros(cap, np.uint16)
            du_p[: du.size] = du
            vals_d = _device_gather_vals_delta(segs_d, _jax.device_put(du_p))
            vals = np.asarray(vals_d[: du.size])[dkeep]
        else:
            cap = _cap_bucket(max(n_real, 4096))
            pos_p = np.full(cap, nseg * seg, dtype=np.int32)
            pos_p[:n_real] = pos
            vals_d = _device_gather_vals(segs_d, _jax.device_put(pos_p))
            vals = np.asarray(vals_d[:n_real])
        return pos, vals

    from concurrent.futures import ThreadPoolExecutor

    bounds = [
        (r0, min(r0 + chunk_rows, nseg)) for r0 in range(0, nseg, chunk_rows)
    ]
    counts = np.add.reduceat(
        lit_counts, [r0 for r0, _ in bounds]
    )  # per-chunk expected literal counts (dense rows are zeroed on device)
    pos_parts: list[np.ndarray] = []
    pending = []  # (vals_dev, du_size, dkeep)
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = [
            ex.submit(lambda a=packed_d[r0:r1]: np.asarray(a))
            for r0, r1 in bounds
        ]
        for (r0, r1), fut, n_c in zip(bounds, futs, counts):
            mask = fut.result()
            n_c = int(n_c)
            if n_c == 0:
                # the mask-disagreement guard must hold chunk-wise: a
                # zero-count chunk whose mask carries set bits means the
                # device and host disagree — bail to transfer exactly
                # like the monolithic whole-mask popcount would
                if mask.any():
                    for f in futs:
                        f.cancel()
                    return None
                continue
            pos_c = _nb_mask_positions(mask.reshape(-1), n_c)
            if pos_c is None or pos_c.size != n_c:
                for f in futs:
                    f.cancel()
                return None
            du, dkeep = _delta_encode_positions(pos_c)
            cap = _cap_bucket(max(du.size, 4096))
            du_p = np.zeros(cap, np.uint16)
            du_p[: du.size] = du
            vals_d = _device_gather_vals_delta_base(
                segs_d, _jax.device_put(du_p), np.int32(r0 * seg)
            )
            pos_parts.append(pos_c.astype(np.int32) + np.int32(r0 * seg))
            pending.append((vals_d, du.size, dkeep))
    if not pos_parts:
        return np.empty(0, np.int32), np.empty(0, np.uint8)
    pos = np.concatenate(pos_parts)
    vals = np.concatenate(
        [np.asarray(v[:k])[keep] for v, k, keep in pending]
    )
    return pos, vals


def _nb_mask_positions(packed_flat: np.ndarray, n: int):
    from .native import backend as _nb

    return _nb.mask_positions(packed_flat, n)


def _delta_encode_positions(pos: np.ndarray):
    """(du16, keep) for _device_gather_vals_delta: the device cumsum of
    du16 visits every position in turn; ``keep`` marks the real entries.

    First step = pos[0], later steps = consecutive diffs; any step over
    65535 splits into 65535-chunks whose intermediate (dummy) entries
    land between the two real positions — valid gather indices whose
    fetched byte the caller discards via ``keep``."""
    k = pos.size
    d = np.empty(k, np.int64)
    if k:
        d[0] = pos[0]
        np.subtract(pos[1:], pos[:-1], out=d[1:])
    reps = np.maximum((d + 65534) // 65535, 1).astype(np.int64)
    total = int(reps.sum())
    du = np.full(total, 65535, np.uint16)
    last = np.cumsum(reps) - 1
    du[last] = (d - 65535 * (reps - 1)).astype(np.uint16)
    keep = np.zeros(total, bool)
    keep[last] = True
    return du, keep


def _open_mask(eq, T: int):
    """Literal mask from a per-row equality mask: a position is a match
    only inside an equality run of length >= T (morphological opening),
    never in the forced row tail.  All data movement is static shifts
    (slice + concat), which fuse into elementwise passes; no gathers or
    reduce_window."""
    import jax.numpy as jnp

    nrows, seg = eq.shape
    eq = eq & (jnp.arange(seg)[None, :] < seg - _ROW_TAIL_LITERALS)
    # opening by T via static shifts: erosion (AND of T shifted views)
    # then dilation (OR of T shifted views)
    er = eq[:, : seg - T + 1]
    for s in range(1, T):
        er = er & eq[:, s : seg - T + 1 + s]
    z = jnp.zeros((nrows, 0), bool)
    match = jnp.zeros((nrows, seg), bool)
    for s in range(T):
        shifted = jnp.concatenate(
            [
                z if s == 0 else jnp.zeros((nrows, s), bool),
                er,
                z if s == T - 1 else jnp.zeros((nrows, T - 1 - s), bool),
            ],
            axis=1,
        )
        match = match | shifted
    return ~match




def compress_array(x, opts: Options | None = None, strategy: str = "transfer") -> bytes:
    """Compress a jax.Array (or ndarray) with the filter stage on device.

    type_size defaults to the dtype's itemsize.

    strategy:
      "transfer" (default) — filter on device, transfer the filtered
        stream, host codec.  Frames BIT-IDENTICAL to the host path.
      "rle" — LZ4 only: filter AND run-length scan on device; only
        O(runs) records reach the host, which emits standard LZ4 token
        streams in O(runs) (native lz4_emit_runs).  Frames are valid
        LZ4 frames decodable everywhere, but not bit-identical to the
        host encoder (different match strategy).  Falls back to
        "transfer" when the data is not run-compressible enough
        (device probe result exceeds the record budget).
      "match" / "auto" — LZ4 only: the dense-segment generalization of
        "rle" (device match DISCOVERY, not just runs): per byte-plane
        row the device picks the best fixed match offset (powers of two
        up to 1024, offset 1 = RLE as a special case), builds the
        literal mask with a morphological opening, and ships only
        (position, byte) literal records; the host serializes standard
        LZ4 streams in O(records) (native lz4_emit_mixed).  Same
        valid-everywhere / not-bit-identical contract and transfer
        fallback as "rle".
    """
    return _compress_array_stage2(_compress_array_stage1(x, opts, strategy))


def _compress_array_stage1(x, opts: Options | None, strategy: str):
    """Device + link half of compress_array, split out so checkpoint
    writers can pipeline it: ("frame", bytes) when the leaf completed
    inline (single-block routing, or a match/rle strategy that engaged),
    else ("filtered", ...) for _compress_array_stage2.  compress_array IS
    stage2(stage1(...)), so pipelined frames are byte-identical by
    construction."""
    import jax
    import jax.numpy as jnp

    if opts is None:
        opts = Options()
    if not isinstance(x, jax.Array):
        host_dtype = np.asarray(x).dtype
        x = jnp.asarray(x)
        if np.dtype(x.dtype) != host_dtype:
            raise TypeError(
                f"jax narrowed {host_dtype} to {x.dtype}; enable jax_enable_x64 "
                "for 64-bit dtypes or pass bytes through compress() instead"
            )
    itemsize = np.dtype(x.dtype).itemsize
    if opts.type_size == Options().type_size and itemsize != opts.type_size:
        opts = Options(
            codec=opts.codec, level=opts.level, shuffle=opts.shuffle,
            type_size=itemsize, block_size=opts.block_size,
            num_threads=opts.num_threads,
        )
    opts = opts.clamped()

    n = int(np.prod(x.shape)) * itemsize
    if n == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")

    from .api import AUTO_BLOCK_THRESHOLD, compress_with_options

    block_size = choose_block_size(n, opts.type_size, opts.block_size)
    nb_full = n // block_size
    do_filter = opts.shuffle != Shuffle.NOSHUFFLE and opts.type_size > 1
    use_chunked = opts.block_size > 0 or n > AUTO_BLOCK_THRESHOLD

    if not use_chunked or not do_filter or nb_full == 0:
        return ("frame", compress_with_options(np.asarray(x).tobytes(), opts))
    if strategy in ("match", "auto") and opts.codec in (Codec.LZ4, Codec.LZ4HC):
        frame = _compress_array_match(x, opts, nb_full, block_size)
        if frame is not None:
            return ("frame", frame)
    if strategy == "rle" and opts.codec in (Codec.LZ4, Codec.LZ4HC):
        frame = _compress_array_rle(x, opts, nb_full, block_size)
        if frame is not None:
            return ("frame", frame)
    return _device_filter_fetch(x, opts, nb_full, block_size)


def _device_filter_fetch(x, opts: Options, nb_full: int, block_size: int):
    filtered_dev, tail_dev = _device_filter_prep(
        x, nb_full, block_size, opts.type_size, int(opts.shuffle), True
    )
    filtered = np.asarray(filtered_dev)  # one transfer
    if filtered.dtype != np.uint8:
        filtered = filtered.view(np.uint8)  # u32 SWAR path: free reinterpret
    filtered = filtered.reshape(-1)
    tail = np.asarray(tail_dev)
    if tail.size:
        if opts.shuffle == Shuffle.SHUFFLE and tail.size >= opts.type_size:
            shuf_tail = filters.shuffle_bytes(tail, opts.type_size)
        elif opts.shuffle == Shuffle.BITSHUFFLE and tail.size >= opts.type_size:
            shuf_tail = filters.bit_shuffle(tail, opts.type_size)
        else:
            shuf_tail = tail
        filtered_all = np.concatenate([filtered, shuf_tail])
    else:
        filtered_all = filtered
    return ("filtered", filtered_all, opts, block_size)


def _compress_array_stage2(staged) -> bytes:
    """Host half of compress_array: codec the filtered stream from
    stage1 into a FLAG_SPLIT frame (pass-through for completed
    ("frame", bytes) stages)."""
    if staged[0] == "frame":
        return staged[1]
    _, filtered_all, opts, block_size = staged
    n = filtered_all.size

    # host codec stage over the pre-filtered stream.  Use the SAME native
    # pipeline as chunk.compress_chunked (shuffle_mode=0 — data is already
    # filtered) so streams and fallback decisions are byte-identical to
    # the host path; memcpy-flagged blocks are then patched to carry raw
    # pre-filter bytes (the format contract, blosc.go:341-345).
    from . import chunk as _chunk

    payloads: list[bytes] = []
    entries: list[int] = []
    native = _chunk._native_pipeline_codec(opts.codec, opts.level)
    if native is not None:
        from .native import backend as _nb

        native_codec, depth = native
        # mode 0|8: data is already filtered on device; bit 3 tells the
        # native layer to CLASSIFY it as filtered (zlib's libdeflate path)
        # so the frame stays byte-identical to the host compressor's
        mode_flag = 8 if int(opts.shuffle) != 0 and opts.type_size > 1 else 0
        payloads, memf = _nb.compress_blocks(
            filtered_all, block_size, opts.type_size, mode_flag,
            native_codec, depth
        )
    else:
        compressor = get_codec(opts.codec)
        if compressor is None:
            raise InvalidCodecError(f"blosc: unsupported codec: {opts.codec}")
        payloads, memf = [], []
        pos = 0
        while pos < n:
            bs = min(block_size, n - pos)
            comp = compressor.compress(
                filtered_all[pos : pos + bs].tobytes(), opts.level
            )
            if len(comp) >= bs:
                payloads.append(filtered_all[pos : pos + bs].tobytes())
                memf.append(True)
            else:
                payloads.append(comp)
                memf.append(False)
            pos += bs
    for i, is_memcpy in enumerate(memf):
        bs = len(payloads[i]) if is_memcpy else None
        if is_memcpy:
            # recover raw pre-filter bytes by unfiltering on the host
            if opts.shuffle == Shuffle.SHUFFLE:
                raw_block = filters.unshuffle_bytes(payloads[i], opts.type_size)
            else:
                raw_block = filters.bit_unshuffle(payloads[i], opts.type_size)
            payloads[i] = raw_block.tobytes()
            entries.append(_ENTRY_MEMCPY | bs)
        else:
            entries.append(len(payloads[i]))

    import struct

    num_blocks = len(payloads)
    table = struct.pack("<I", num_blocks) + struct.pack(
        f"<{num_blocks}I", *entries
    )
    total = HEADER_SIZE + len(table) + sum(len(p) for p in payloads)
    flags = FLAG_SPLIT | (
        FLAG_SHUFFLE if opts.shuffle == Shuffle.SHUFFLE else FLAG_BITSHUFFLE
    )
    header = Header(
        version=FORMAT_VERSION,
        version_lz=int(opts.codec),
        flags=flags,
        type_size=min(opts.type_size, 255),
        nbytes_orig=n,
        block_size=block_size,
        nbytes_comp=total,
    )
    return header.to_bytes() + table + b"".join(payloads)


def _unfilter_host(block, type_size: int, mode: Shuffle) -> bytes:
    if mode == Shuffle.SHUFFLE:
        return filters.unshuffle_bytes(block, type_size).tobytes()
    return filters.bit_unshuffle(block, type_size).tobytes()


def _filter_host(block, type_size: int, mode: Shuffle) -> bytes:
    if len(block) < type_size or type_size <= 1:
        return bytes(block)
    if mode == Shuffle.SHUFFLE:
        return filters.shuffle_bytes(block, type_size).tobytes()
    return filters.bit_shuffle(block, type_size).tobytes()


def _reconstruct_match_row(
    seg: int, d: int, rel_pos: np.ndarray, vals: np.ndarray
) -> np.ndarray:
    """Rebuild a filtered row from literal records: out[i] = literal or
    out[i-d].  Vectorized via the residue reshape; rows whose length is
    not a multiple of d are padded to one and sliced back (non-pow2
    periods like 3/96 never divide pow2 segments).  Positions < d are
    always literal, so every residue column head is seeded."""
    if d == 1:
        row = np.zeros(seg, np.uint8)
        row[rel_pos] = vals
        idx = np.zeros(seg, np.int64)
        idx[rel_pos] = rel_pos
        np.maximum.accumulate(idx, out=idx)
        return row[idx]
    m = -(-seg // d)  # ceil
    row = np.zeros(m * d, np.uint8)
    row[rel_pos] = vals
    mask = np.zeros(m * d, bool)
    mask[rel_pos] = True
    idxm = np.where(mask.reshape(m, d), np.arange(m)[:, None], 0)
    np.maximum.accumulate(idxm, axis=0, out=idxm)
    out = np.take_along_axis(row.reshape(m, d), idxm, axis=0).reshape(-1)
    return out[:seg]


def _compress_array_match(x, opts: Options, nb_full: int, block_size: int):
    """Device match-discovery strategy: fixed-offset matches per byte plane.

    The dense-segment extension of the RLE strategy (≙ the parallel
    hash-match half of the BASELINE north star): the device picks the best
    match offset per byte-plane row (powers of two — the periods shuffled
    numeric data actually exhibits), builds the literal mask with a
    morphological opening (match runs >= _MATCH_T survive), and ships only
    (position, byte) literal records.  The host serializes standard LZ4
    token streams in O(records) via lz4_emit_mixed; blocks that stay dense
    cross the link as bytes and use the normal native encoder.  Frames are
    valid LZ4 everywhere (not bit-identical to the host encoder — same
    contract as the RLE strategy).  Returns None when not enough rows are
    record-compressible (plain transfer is strictly better then).
    """
    from .codecs.lz4_ref import hc_depth_for_level
    from .native import backend as _nb

    if not _nb.available():
        return None
    ts = opts.type_size
    if block_size % ts:
        return None
    seg = block_size // ts
    if seg < 256:
        return None
    if nb_full * block_size >= 2**31:
        return None  # literal positions are int32 flat indices
    offsets = _match_offsets(seg)
    if not offsets:
        return None
    segs_d, best_d, lc_d, packed_d, tail_d = _device_match_pipeline(
        x, nb_full, block_size, ts, int(opts.shuffle), seg, offsets
    )
    lit_counts = np.asarray(lc_d).astype(np.int64)
    tail = np.asarray(tail_d)
    offs = np.asarray(offsets, dtype=np.int32)
    d_all = offs[np.asarray(best_d)]  # (nseg,)
    nseg = d_all.size

    # a record row ships ~5 B per literal; require a 2x margin over bytes
    sparse = lit_counts <= seg // 10
    sparse_idx = np.flatnonzero(sparse)
    dense_idx = np.flatnonzero(~sparse)
    if sparse_idx.size * seg < (nseg * seg) // 8:
        return None  # <12.5% of bytes record-covered: transfer is simpler

    depth = hc_depth_for_level(opts.level) if opts.codec == Codec.LZ4HC else 1

    # --- literal records for sparse rows: packed mask (n/8 bytes) ->
    # positions -> one value gather, with the fetch/scan/upload/gather
    # stages overlapped on big masks (see _fetch_match_records) ---
    n_real = int(lit_counts[sparse_idx].sum())
    fetched = _fetch_match_records(
        segs_d, packed_d, np.where(sparse, lit_counts, 0), seg, n_real
    )
    if fetched is None:  # mask disagreement: bail safely
        return None
    pos, vals = fetched
    # keys must match pos's int32 dtype: int64 keys make numpy promote
    # (copy) the whole position array — measured 0.47 s at 256 MiB vs
    # sub-ms for the same search with int32 keys.  Values fit: the match
    # path bails for inputs >= 2 GiB (flat positions are int32).
    rec_first = np.searchsorted(pos, (sparse_idx * seg).astype(np.int32))
    rec_last = np.append(rec_first[1:], n_real)

    # --- bytes for dense rows (one gather, one transfer) ---
    if dense_idx.size:
        dense = np.asarray(
            _device_rows_gather(
                segs_d,
                _jax.device_put(dense_idx.astype(np.int32)),
                int(dense_idx.size),
            )
        )

    sparse_pos_of = {int(s): j for j, s in enumerate(sparse_idx)}
    row_sparse = sparse.reshape(nb_full, ts)
    payloads: list[bytes] = [b""] * nb_full
    entries: list[int] = [0] * nb_full
    rebuild_blocks: list[int] = []
    for blk in range(nb_full):
        if row_sparse[blk].all():
            # direct O(records) emission: concatenate the block's rows'
            # records into block-relative positions
            parts_p, parts_v = [], []
            for t in range(ts):
                s = blk * ts + t
                j = sparse_pos_of[s]
                a, b = int(rec_first[j]), int(rec_last[j])
                parts_p.append(pos[a:b] - s * seg + t * seg)
                parts_v.append(vals[a:b])
            stream = _nb.lz4_emit_mixed(
                np.concatenate(parts_p), np.concatenate(parts_v),
                d_all[blk * ts : (blk + 1) * ts], seg, block_size,
                cap=block_size // 4,
            )
            if stream is not None:
                payloads[blk] = stream
                entries[blk] = len(stream)
                continue
        rebuild_blocks.append(blk)

    # --- rebuild + native-encode the remaining blocks ---
    if rebuild_blocks:
        parts = []
        for blk in rebuild_blocks:
            for t in range(ts):
                s = blk * ts + t
                j = sparse_pos_of.get(s)
                if j is None:
                    parts.append(dense[np.searchsorted(dense_idx, s)])
                else:
                    a, b = int(rec_first[j]), int(rec_last[j])
                    parts.append(
                        _reconstruct_match_row(
                            seg, int(d_all[s]), pos[a:b] - s * seg, vals[a:b]
                        )
                    )
        db = np.concatenate(parts)
        dpayloads, dmem = _nb.compress_blocks(
            db, block_size, ts, 0,
            _nb.NATIVE_LZ4HC if opts.codec == Codec.LZ4HC else _nb.NATIVE_LZ4,
            depth,
        )
        for j, blk in enumerate(rebuild_blocks):
            if dmem[j]:
                payloads[blk] = _unfilter_host(
                    np.frombuffer(dpayloads[j], np.uint8), ts, opts.shuffle
                )
                entries[blk] = _ENTRY_MEMCPY | block_size
            else:
                payloads[blk] = dpayloads[j]
                entries[blk] = len(dpayloads[j])

    n = nb_full * block_size + tail.size
    if tail.size:
        shuf_t = _filter_host(tail.tobytes(), ts, opts.shuffle)
        compressor = get_codec(opts.codec)
        comp = compressor.compress(shuf_t, opts.level)
        if len(comp) >= tail.size:
            payloads.append(tail.tobytes())
            entries.append(_ENTRY_MEMCPY | tail.size)
        else:
            payloads.append(comp)
            entries.append(len(comp))

    import struct

    num_blocks = len(payloads)
    table = struct.pack("<I", num_blocks) + struct.pack(
        f"<{num_blocks}I", *entries
    )
    flags = FLAG_SPLIT | (
        FLAG_SHUFFLE if opts.shuffle == Shuffle.SHUFFLE else FLAG_BITSHUFFLE
    )
    header = Header(
        version=FORMAT_VERSION,
        version_lz=int(opts.codec),
        flags=flags,
        type_size=min(ts, 255),
        nbytes_orig=n,
        block_size=block_size,
        nbytes_comp=HEADER_SIZE + len(table) + sum(len(p) for p in payloads),
    )
    return header.to_bytes() + table + b"".join(payloads)


def _compress_array_rle(x, opts: Options, nb_full: int, block_size: int):
    """Device-RLE strategy body: per-SEGMENT mixed record/byte transfer.

    Each block's byte planes are scanned for runs on device; run-sparse
    segments cross the link as (value, length) records, dense segments as
    bytes.  The filtered stream is reconstructed on the host (np.repeat +
    row placement — memory-speed) and encoded with the normal native
    pipeline; blocks whose every segment is sparse skip reconstruction and
    use the O(runs) emitter directly.  Returns None when nothing is
    sparse (the plain transfer path is strictly better then).
    """
    from .codecs.lz4_ref import hc_depth_for_level
    from .native import backend as _nb

    if not _nb.available():
        return None
    ts = opts.type_size
    if block_size % ts:
        return None
    seg = block_size // ts
    nseg = nb_full * ts
    segs_d, counts_d, tail_d = _device_filter_seg_counts(
        x, nb_full, block_size, ts, int(opts.shuffle), seg
    )
    counts = np.asarray(counts_d).astype(np.int64)
    tail = np.asarray(tail_d)

    # records cost ~5 B/run on the link; a segment is "sparse" when that
    # undercuts its bytes by ~8x
    sparse = counts <= max(seg // 40, 64)
    sparse_idx = np.flatnonzero(sparse)
    dense_idx = np.flatnonzero(~sparse)
    if sparse_idx.size * seg < (nseg * seg) // 8:
        return None  # <12.5% of bytes sparse: transfer path is simpler

    depth = hc_depth_for_level(opts.level) if opts.codec == Codec.LZ4HC else 1

    # --- records for sparse segments (one device scan, O(runs) transfer) ---
    k = sparse_idx.size
    k_pad = _pow2(k)
    rows = np.concatenate(
        [sparse_idx, np.full(k_pad - k, sparse_idx[-1])]
    ).astype(np.int32)
    n_real = int(counts[sparse_idx].sum())
    cap = _pow2(max(n_real + (k_pad - k) * int(counts[sparse_idx[-1]]), 4096))
    vals_d, lens_d = _device_rows_rle(segs_d, _jax.device_put(rows), k_pad, cap)
    vals = np.asarray(vals_d[:n_real])
    lens = np.asarray(lens_d[:n_real]).astype(np.int64)
    ends = np.cumsum(lens)
    rec_first = np.searchsorted(ends - lens, np.arange(k) * seg)
    rec_last = np.append(rec_first[1:], n_real)

    # --- bytes for dense segments (one gather, one transfer) ---
    if dense_idx.size:
        dense = np.asarray(
            _device_rows_gather(
                segs_d,
                _jax.device_put(dense_idx.astype(np.int32)),
                int(dense_idx.size),
            )
        )

    # --- reconstruct the filtered stream on the host ---
    buf = np.empty((nseg, seg), dtype=np.uint8)
    for j in range(k):
        a, b = int(rec_first[j]), int(rec_last[j])
        buf[sparse_idx[j]] = np.repeat(vals[a:b], lens[a:b])
    if dense_idx.size:
        buf[dense_idx] = dense
    flat = buf.reshape(-1)

    # --- encode: emit records directly for fully-sparse blocks, native
    #     pipeline for the rest ---
    seg_sparse = sparse.reshape(nb_full, ts)
    payloads: list[bytes] = [b""] * nb_full
    entries: list[int] = [0] * nb_full
    dense_blocks = []
    for blk in range(nb_full):
        if seg_sparse[blk].all():
            s0 = blk * ts  # first segment of the block, in sparse ordering
            j0 = int(np.searchsorted(sparse_idx, s0))
            a = int(rec_first[j0])
            b = int(rec_last[j0 + ts - 1])
            stream = _nb.lz4_emit_runs(vals[a:b], lens[a:b], block_size)
            if len(stream) <= block_size // 16:
                payloads[blk] = stream
                entries[blk] = len(stream)
                continue
        dense_blocks.append(blk)
    if dense_blocks:
        db = np.concatenate(
            [flat[blk * block_size : (blk + 1) * block_size] for blk in dense_blocks]
        )
        dpayloads, dmem = _nb.compress_blocks(
            db, block_size, ts, 0,
            _nb.NATIVE_LZ4HC if opts.codec == Codec.LZ4HC else _nb.NATIVE_LZ4,
            depth,
        )
        for j, blk in enumerate(dense_blocks):
            if dmem[j]:
                payloads[blk] = _unfilter_host(
                    np.frombuffer(dpayloads[j], np.uint8), ts, opts.shuffle
                )
                entries[blk] = _ENTRY_MEMCPY | block_size
            else:
                payloads[blk] = dpayloads[j]
                entries[blk] = len(dpayloads[j])

    n = nb_full * block_size + tail.size
    if tail.size:
        shuf_t = _filter_host(tail.tobytes(), ts, opts.shuffle)
        compressor = get_codec(opts.codec)
        comp = compressor.compress(shuf_t, opts.level)
        if len(comp) >= tail.size:
            payloads.append(tail.tobytes())
            entries.append(_ENTRY_MEMCPY | tail.size)
        else:
            payloads.append(comp)
            entries.append(len(comp))

    import struct

    num_blocks = len(payloads)
    table = struct.pack("<I", num_blocks) + struct.pack(
        f"<{num_blocks}I", *entries
    )
    flags = FLAG_SPLIT | (
        FLAG_SHUFFLE if opts.shuffle == Shuffle.SHUFFLE else FLAG_BITSHUFFLE
    )
    header = Header(
        version=FORMAT_VERSION,
        version_lz=int(opts.codec),
        flags=flags,
        type_size=min(ts, 255),
        nbytes_orig=n,
        block_size=block_size,
        nbytes_comp=HEADER_SIZE + len(table) + sum(len(p) for p in payloads),
    )
    return header.to_bytes() + table + b"".join(payloads)


def _decode_row_chunk(nseg: int, seg: int, target_bytes: int = 512 << 20) -> int:
    """Rows per fill chunk: largest divisor of nseg whose chunk stays under
    ``target_bytes`` of row data, so per-offset scan intermediates are
    memory-bounded no matter how many distinct offsets a frame uses.
    Offsets are processed sequentially inside a chunk, so peak memory is
    a few multiples of the chunk, not K of them, while typical inputs
    avoid lax.scan serialization."""
    cap = max(1, target_bytes // max(seg, 1))
    c = min(nseg, cap)
    while nseg % c:
        c -= 1
    return c


# level-1 block length for the two-level forward fill: (idx+1)<<8 | value
# keys fit uint16 (129<<8 | 255 = 33023), halving scan traffic vs int32
_FILL_L1 = 128


@partial(_jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def _device_match_decode(
    vals, pos, sel, offsets: tuple, nseg: int, seg: int,
    bs: int, type_size: int, mode: int,
):
    """Reconstruct + unfilter from literal records in ONE compiled program.

    out[i] = literal where present else out[i - d_row]; per offset d the
    residue reshape (d | seg) turns the recurrence into a forward fill.
    No gathers, no jit boundaries.

    - ONE uint16 scatter of 0x100|value (literal flag in bit 8) instead
      of a uint8+bool scatter pair.  Positions from np.flatnonzero are
      sorted and unique, so XLA gets both hints.
    - Forward fill is TWO-LEVEL when the residue height m >= 1024:
      cummax of uint16 (idx+1)<<8|value keys within _FILL_L1-row blocks
      (half the traffic of int32), then an int32 cummax over per-block
      last keys, then a where-combine.  This also removes the 2**23
      index-overflow regime for every practical shape (level-2 indices
      are m/128); the overflow-free pair scan remains only for absurd
      residue heights (seg/d >= 2**30).
    - Small m takes a single int32-key cummax (few passes, not worth
      blocking); K == 1 frames skip the one-hot select entirely.
    A ``lax.scan`` over row groups still bounds peak memory so ANY number
    of distinct offsets compiles (round 2 capped at 4 — lifted).
    """
    import jax
    import jax.numpy as jnp

    total = nseg * seg
    comb = vals.astype(jnp.uint16) | jnp.uint16(0x100)
    grid = jnp.zeros(total, jnp.uint16).at[pos].set(
        comb, mode="drop", unique_indices=True, indices_are_sorted=True
    )
    K = len(offsets)
    c = _decode_row_chunk(nseg, seg)
    g = nseg // c
    g3 = grid.reshape(g, c, seg)
    s3 = sel.reshape(g, c, -1)

    def _last_valid(a, b):
        af, av = a
        bf, bv = b
        return af | bf, jnp.where(bf, bv, av)

    def _fill_offset(gc, d):
        """Forward-fill one offset's residue reshape of the (c, seg) u16
        grid; returns the filled (c, seg) uint8."""
        m = -(-seg // d)  # ceil: pad rows when d does not divide seg
        L1 = _FILL_L1
        if m >= 1024 and (m * d) < 2**30:
            m1 = -(-m // L1)
            pad = m1 * L1 * d - seg
            gp = jnp.pad(gc, ((0, 0), (0, pad))) if pad else gc
            gr = gp.reshape(c, m1, L1, d)
            idx2 = jnp.arange(L1, dtype=jnp.uint16)[None, None, :, None]
            l1 = jnp.where(gr != 0, ((idx2 + 1) << 8) | (gr & 0xFF), 0)
            l1 = jax.lax.cummax(l1, axis=2)
            last = l1[:, :, -1, :]  # (c, m1, d) u16
            idx1 = jnp.arange(m1, dtype=jnp.int32)[None, :, None]
            k2 = jnp.where(
                last != 0,
                ((idx1 + 1) << 8) | (last & 0xFF).astype(jnp.int32),
                0,
            )
            k2 = jax.lax.cummax(k2, axis=1)
            prev = jnp.concatenate(
                [jnp.zeros((c, 1, d), jnp.int32), k2[:, :-1, :]], axis=1
            )
            prev_val = (prev & 0xFF).astype(jnp.uint8)[:, :, None, :]
            fill = jnp.where(l1 != 0, (l1 & 0xFF).astype(jnp.uint8), prev_val)
            return fill.reshape(c, m1 * L1 * d)[:, :seg]
        pad = m * d - seg
        gp = jnp.pad(gc, ((0, 0), (0, pad))) if pad else gc
        gr = gp.reshape(c, m, d)
        if m + 1 < 2**23:
            key = jnp.where(
                gr != 0,
                ((jnp.arange(m, dtype=jnp.int32)[None, :, None] + 1) << 8)
                | (gr & 0xFF).astype(jnp.int32),
                0,
            )
            key = jax.lax.cummax(key, axis=1)
            fill = (key & 0xFF).astype(jnp.uint8)
        else:  # pragma: no cover - needs seg/d >= 2**30
            _, fill = jax.lax.associative_scan(
                _last_valid, (gr != 0, (gr & 0xFF).astype(jnp.uint8)), axis=1
            )
        return fill.reshape(c, m * d)[:, :seg]

    def _fill_chunk(_, xs):
        gc, sc = xs  # (c, seg) uint16, (c, K) bool
        out = None
        for i, d in enumerate(offsets):
            fill = _fill_offset(gc, d)
            if K == 1:
                out = fill
            else:
                o = jnp.zeros((c, seg), jnp.uint8) if out is None else out
                out = jnp.where(sc[:, i : i + 1], fill, o)
        return None, out

    if g == 1:
        _, out = _fill_chunk(None, (g3[0], s3[0]))
    else:
        _, chunks = jax.lax.scan(_fill_chunk, None, (g3, s3))
        out = chunks.reshape(nseg, seg)

    from .filters import batched as fb

    blocks = out.reshape(-1, bs)
    if mode == int(Shuffle.SHUFFLE):
        res = fb._unshuffle_batch_dev(blocks, type_size)
    else:
        res = fb._bit_unshuffle_batch_dev(blocks, type_size)
    return res.reshape(-1)


def _lit_eq(rows2d: np.ndarray, d_all: np.ndarray) -> np.ndarray:
    """Per-row fixed-offset equality, grouped by unique offset and done
    with plain slicing — a broadcast take_along_axis gather here
    measured 4.4 s on 256 MiB vs ~0.1 s for the slice form — with the
    forced-literal tail already applied."""
    nseg, seg = rows2d.shape
    eq = np.zeros((nseg, seg), bool)
    for d in np.unique(d_all):
        sel = d_all == d
        sub = rows2d[sel]
        eq[sel, int(d):] = sub[:, int(d):] == sub[:, : seg - int(d)]
    eq[:, seg - _ROW_TAIL_LITERALS :] = False
    return eq


def _host_lit_mask(rows2d: np.ndarray, d_all: np.ndarray, T: int) -> np.ndarray:
    """Host mirror of _lit_mask (NumPy): literal positions per row under
    per-row offsets, with the same opening + forced-literal rules."""
    eq = _lit_eq(rows2d, d_all)
    seg = rows2d.shape[1]
    if seg % 64 == 0 and T <= 63:
        return _open_mask_bits(eq, T)
    return _open_mask_bytes(eq, T)


def _host_lit_mask_packed(
    rows2d: np.ndarray, d_all: np.ndarray, T: int
) -> np.ndarray | None:
    """Little-endian PACKED literal mask ((nseg, seg//8) u8) — skips the
    unpack-to-bool pass entirely so the decode can count set bits with
    bitwise_count and scan positions with the native ctz scanner.  None
    when the row geometry doesn't fit the bit-domain opening."""
    seg = rows2d.shape[1]
    if seg % 64 or T > 63:
        return None
    return _open_mask_bits(_lit_eq(rows2d, d_all), T, packed=True)


def _open_mask_bytes(eq: np.ndarray, T: int) -> np.ndarray:
    """Morphological opening (erode by T, dilate by T) in the byte
    domain — the oracle form; ~15 full passes over the mask."""
    nseg, seg = eq.shape
    er = eq[:, : seg - T + 1].copy()
    for s in range(1, T):
        er &= eq[:, s : seg - T + 1 + s]
    match = np.zeros_like(eq)
    for s in range(T):
        match[:, s : seg - T + 1 + s] |= er
    return ~match


def _open_mask_bits(
    eq: np.ndarray, T: int, packed: bool = False
) -> np.ndarray:
    """Opening in the bit domain: pack rows to little-endian u64 words
    and run the shift-AND / shift-OR ladders on n/64 words with explicit
    cross-word carries (rows never carry into each other).  8x less
    traffic than the byte form — the opening drops from ~1.1 s to ~0.1 s
    at 256 MiB.  Bit-identical to _open_mask_bytes (tests enforce)."""
    nseg, seg = eq.shape
    w = np.packbits(eq, axis=1, bitorder="little").view(np.uint64)
    nxt = np.zeros_like(w)
    nxt[:, :-1] = w[:, 1:]
    er = w.copy()
    for s in range(1, T):
        er &= (w >> np.uint64(s)) | (nxt << np.uint64(64 - s))
    prv = np.zeros_like(er)
    prv[:, 1:] = er[:, :-1]
    match = er.copy()
    for s in range(1, T):
        match |= (er << np.uint64(s)) | (prv >> np.uint64(64 - s))
    lit_packed = (~match).view(np.uint8).reshape(nseg, seg // 8)
    if packed:
        return lit_packed
    return np.unpackbits(lit_packed, axis=1, bitorder="little").view(bool)


def decompress_array(data, dtype, shape=None, sharding=None,
                     strategy: str = "auto"):
    """Decompress a frame and place the result on device.

    Returns a jax.Array of ``dtype`` (and ``shape`` if given, else 1-D),
    optionally placed with ``sharding`` (a jax.sharding.Sharding).

    strategy "rle"/"records": for filtered multi-block LZ4 frames whose
    decoded-but-still-filtered stream is record-sparse, only (position,
    byte) literal records cross the host→device link and the device
    reconstructs + unfilters (offset forward-fill).  "auto" (default) and
    "transfer" ship the decoded bytes.  Records ship fewer bytes than
    transfer; they stay opt-in because the decode programs cost a long
    first-call compile and dense frames gain nothing.

    strategy "device": the decode mirror of compress_array's on-device
    filtering — the host runs only the codec stage (shuffle_mode=0, no
    unfiltering), the still-filtered stream uploads as a free u32 word
    view, and the SWAR kernels unfilter on device, which frees the host
    cores.  Same bytes on the wire as "transfer".  Falls back to the
    transfer path when the frame doesn't qualify (non-split, unfiltered,
    a dtype whose width is not the frame's type size 2, 4 or 8,
    unaligned blocks).
    """
    import jax

    dt = np.dtype(dtype)
    n = _checked_decode_size(data, dt)
    if strategy == "device":
        out = _decompress_array_devfilter(data, n, dt, shape, sharding)
        if out is not None:
            return out
    if strategy in ("rle", "records") and sharding is None:
        out = _decompress_array_rle(data, n, dt, shape)
        if out is not None:
            return out
    host = _host_decode_frame(data, n, dt, shape)
    if sharding is not None:
        return jax.device_put(host, sharding)
    return jax.device_put(host)


def _checked_decode_size(data, dt: np.dtype) -> int:
    """decompress_array's front validation (size divisibility, 64-bit
    narrowing guard); shared with the pipelined checkpoint loader so
    errors match the serial path exactly."""
    import jax

    from .api import get_decompressed_size

    n = get_decompressed_size(data)
    if n % dt.itemsize:
        raise InvalidDataError(
            f"blosc: {n} bytes is not a whole number of {dt} elements"
        )
    if dt.itemsize == 8 and dt.kind in "fiu" and not jax.config.jax_enable_x64:
        raise TypeError(
            f"decompress_array({dt}) requires jax_enable_x64 — jax would "
            "silently narrow the values otherwise"
        )
    return n


def _host_decode_frame(data, n: int, dt: np.dtype, shape) -> np.ndarray:
    """Host half of decompress_array's transfer path (decode into a fresh
    array, apply shape); split out so checkpoint loaders can run it on a
    prefetch thread and keep only the device_put on the caller."""
    from .api import decompress_into

    host = np.empty(n // dt.itemsize, dtype=dt)
    decompress_into(data, host.view(np.uint8))
    if shape is not None:
        host = host.reshape(shape)
    return host


def _swar_unfilter_kernel(mode: int, ts: int):
    from .filters import batched as fbat

    if mode == int(Shuffle.SHUFFLE):
        return fbat._SWAR_UNSHUFFLE[ts]
    return fbat._SWAR_BIT_UNSHUFFLE[ts][0]


def _words_as(words, dt: np.dtype):
    """Free bitcast of (nb, W) u32 words to a flat array of ``dt``."""
    import jax

    if dt.itemsize <= 4:
        return jax.lax.bitcast_convert_type(words, dt).reshape(-1)
    return jax.lax.bitcast_convert_type(
        words.reshape(-1, dt.itemsize // 4), dt
    )


@partial(_jax.jit, static_argnums=(1, 2))
def _dev_unfilter_words(xw, mode: int, dt_name: str):
    """SWAR unfilter of (nb, bs//4) u32 word rows + free bitcast to the
    element dtype, whose width is the type size; ONE compiled program for
    the device half of the 'device' decode strategy."""
    import jax

    dt = np.dtype(dt_name)
    kern = _swar_unfilter_kernel(mode, dt.itemsize)
    # barrier: keeps the flatten from fusing into the kernel's interleave
    out = jax.lax.optimization_barrier(kern(xw))
    return _words_as(out, dt)


@partial(_jax.jit, static_argnums=(2, 3))
def _dev_unfilter_words_masked(xw, keep_raw, mode: int, dt_name: str):
    """As _dev_unfilter_words, but memcpy-flagged rows (keep_raw, (nb, 1)
    bool) pass through untouched — those blocks carry RAW bytes in the
    frame (format contract, api.py docstring)."""
    import jax
    import jax.numpy as jnp

    dt = np.dtype(dt_name)
    kern = _swar_unfilter_kernel(mode, dt.itemsize)
    out = jax.lax.optimization_barrier(jnp.where(keep_raw, xw, kern(xw)))
    return _words_as(out, dt)


def _decode_filtered_blocks(
    raw: bytes, header, n: int, native_codec: int, forbid_memcpy: bool = False
):
    """Host decode of a FLAG_SPLIT frame's blocks to the still-FILTERED
    stream (shuffle_mode=0 skips unfiltering).

    Returns (u8 byte view, block-table entries) or None on layout/bounds
    problems (callers fall back to the canonical host path, which raises
    with full context).  memcpy-flagged blocks come back RAW — the frame
    stores them unfiltered (format contract) — so callers must apply
    their own memcpy policy — or pass ``forbid_memcpy`` to bail cheaply
    before the decode.  Shared by the 'device' and 'records' decode
    strategies."""
    from . import chunk as _chunk
    from .native import backend as _nb

    if header.nbytes_comp > len(raw) or header.nbytes_comp < HEADER_SIZE:
        return None  # canonical path raises the proper truncation error
    entries, offset = _chunk.parse_block_table(raw, header)
    expected = -(-n // header.block_size) if n else 0
    if len(entries) != expected:
        return None
    if forbid_memcpy and any(m for _, m in entries):
        return None
    psizes = np.array([s for s, _ in entries], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(psizes[:-1])]).astype(
        np.int64
    ) + offset
    if int(offsets[-1] + psizes[-1]) > min(len(raw), header.nbytes_comp):
        return None
    filtered = _nb.decompress_blocks(
        np.frombuffer(raw, np.uint8), offsets, psizes,
        np.array([m for _, m in entries], np.uint8), header.block_size, n,
        header.type_size, 0, native_codec,
    )
    return np.frombuffer(filtered, np.uint8), entries


def _decompress_array_devfilter(data, n: int, dt, shape, sharding):
    """strategy='device' decode body; None when the frame doesn't qualify.

    Decode mirror of compress_array's device filtering (≙ the decompress
    capability of the reference's codec.go:77-84, with the filter stage
    on the accelerator): host codec decode with shuffle_mode=0, free u32
    word view upload, SWAR unfilter + bitcast on device, ragged tail
    unfiltered on host and concatenated on device.
    """
    import jax
    import jax.numpy as jnp

    from . import chunk as _chunk
    from . import filters as _filters
    from .format import parse_header
    from .native import backend as _nb

    raw = bytes(data) if not isinstance(data, bytes) else data
    if len(raw) < HEADER_SIZE or raw[:4] == b"TPB2" or not _nb.available():
        return None
    header = parse_header(raw)
    if header.has_bitshuffle:
        mode = int(Shuffle.BITSHUFFLE)
    elif header.has_shuffle:
        mode = int(Shuffle.SHUFFLE)
    else:
        return None
    from .filters import batched as fbat

    ts = header.type_size
    if not header.is_split or ts not in (2, 4, 8) or dt.itemsize != ts:
        return None
    bs = header.block_size
    if mode == int(Shuffle.BITSHUFFLE):
        quant = fbat._SWAR_BIT_UNSHUFFLE[ts][1]
    else:
        quant = fbat._SWAR_QUANTA[ts]
    if bs % quant:
        return None
    native = _chunk._native_pipeline_codec(header.codec, 1)
    if native is None:
        return None
    nb_full = n // bs
    if nb_full == 0:
        return None
    decoded = _decode_filtered_blocks(raw, header, n, native[0])
    if decoded is None:
        return None
    a, entries = decoded
    memcpy_rows = np.array([m for _, m in entries[:nb_full]], bool)
    w = a[: nb_full * bs].reshape(nb_full, bs).view(np.uint32)  # free
    xw = jax.device_put(w)
    if memcpy_rows.any():
        body = _dev_unfilter_words_masked(
            xw, jax.device_put(memcpy_rows[:, None]), mode, dt.name
        )
    else:
        body = _dev_unfilter_words(xw, mode, dt.name)
    tail = a[nb_full * bs :]
    if tail.size:
        if not entries[nb_full][1] and tail.size >= ts:  # not memcpy
            if mode == int(Shuffle.SHUFFLE):
                tail = _filters.unshuffle_bytes(tail, ts)
            else:
                tail = _filters.bit_unshuffle(tail, ts)
        out = jnp.concatenate([body, jax.device_put(tail.view(dt.name))])
    else:
        out = body
    if shape is not None:
        out = out.reshape(shape)
    if sharding is not None:
        return jax.device_put(out, sharding)
    return out


def _decompress_array_rle(data, n: int, dt, shape):
    """RLE decode body; None when the frame/data doesn't qualify."""
    import jax

    from . import chunk as _chunk
    from .format import parse_header
    from .native import backend as _nb

    raw = bytes(data) if not isinstance(data, bytes) else data
    if len(raw) < 4 or raw[:4] == b"TPB2" or not _nb.available():
        return None
    header = parse_header(raw)
    if (
        not header.is_split
        or header.shuffle_mode == Shuffle.NOSHUFFLE
        or header.type_size <= 1
        or header.codec not in (Codec.LZ4, Codec.LZ4HC)
        or n % header.block_size  # ragged tail: host path keeps it simple
        or header.block_size % header.type_size
    ):
        return None
    native = _chunk._native_pipeline_codec(header.codec, 1)
    if native is None:
        return None
    # memcpy blocks hold RAW bytes, not filtered ones: bail before decode
    decoded = _decode_filtered_blocks(
        raw, header, n, native[0], forbid_memcpy=True
    )
    if decoded is None:
        return None
    a, _ = decoded

    def _host_fallback():
        # dense: reinflating via records would ship more than the bytes;
        # unfilter on host and transfer plainly
        host_bytes = np.empty(n, np.uint8)
        from .api import decompress_into

        decompress_into(raw, host_bytes)
        out = host_bytes.view(dt)
        return jax.device_put(out.reshape(shape) if shape is not None else out)

    seg = header.block_size // header.type_size
    if seg < 256 or n % seg:
        return None
    if n >= 2**31:
        return _host_fallback()  # literal positions are int32 flat indices
    offsets_c = _match_offsets(seg)
    if not offsets_c:
        return None
    nseg = n // seg
    rows2d = a.reshape(nseg, seg)
    # offset choice from a sampled prefix of each row (cheap), then the
    # exact literal mask for the chosen offsets (one full host pass)
    samp = rows2d[:, : min(seg, 8192)]
    counts = np.stack(
        [(samp[:, d:] == samp[:, :-d]).sum(axis=1) for d in offsets_c], axis=1
    )
    d_all = np.asarray(offsets_c, np.int32)[counts.argmax(axis=1)]
    packed = _host_lit_mask_packed(rows2d, d_all, _MATCH_T)
    if packed is not None:
        # packed fast path: popcount via bitwise_count, positions via the
        # native ctz scanner — skips the unpack-to-bool + flatnonzero
        # passes (records decode 2.5 -> ~1.7 s at 256 MiB)
        n_real = int(np.bitwise_count(packed).sum(dtype=np.int64))
        if n_real > max(a.size // 8, 4096):
            return _host_fallback()
        relpos = _nb.mask_positions(packed.reshape(-1), n_real)
        if relpos is None or relpos.size != n_real:
            return None  # disagreement: canonical host path decides
    else:
        lit = _host_lit_mask(rows2d, d_all, _MATCH_T)
        if int(lit.sum()) > max(a.size // 8, 4096):
            return _host_fallback()
        relpos = np.flatnonzero(lit).astype(np.int32)

    # single-jit device reconstruction: scatter literals, forward-fill per
    # PRESENT offset, per-row select, unfilter — O(literals) link traffic.
    # Only the offsets that actually won a row are compiled in; the fill
    # is row-group-chunked (see _device_match_decode) so any number of
    # distinct offsets stays HBM-resident (round 2 capped at 4).
    present = tuple(sorted(int(d) for d in np.unique(d_all)))
    vals = rows2d.reshape(-1)[relpos]
    cap = _cap_bucket(max(relpos.size, 4096))
    pos_p = np.full(cap, nseg * seg, np.int32)  # OOB pads are dropped
    pos_p[: relpos.size] = relpos
    vals_p = np.zeros(cap, np.uint8)
    vals_p[: relpos.size] = vals
    best = np.searchsorted(np.asarray(present), d_all)
    sel = np.zeros((nseg, len(present)), bool)
    sel[np.arange(nseg), best] = True
    flat = _device_match_decode(
        jax.device_put(vals_p), jax.device_put(pos_p), jax.device_put(sel),
        present, nseg, seg,
        header.block_size, header.type_size, int(header.shuffle_mode),
    )
    out = flat.view(dt.name) if flat.dtype != dt else flat
    return out.reshape(shape) if shape is not None else out
