"""Multi-block chunked frames — this library's extension (FLAG_SPLIT).

The reference always emits a single block ("Single block for simplicity",
blosc.go:364) and defines but never sets the 0x8 split flag (blosc.go:114).
We use that reserved bit for real multi-block framing — the parallelism
unit for device batching and multi-chip sharding (SURVEY §5 "long-context"
analogue).  Reference-produced single-block frames never set FLAG_SPLIT, so
both formats coexist: decompress() routes on the flag.

Multi-block frame layout (all little-endian):

    bytes 0-15   standard 16-byte header, FLAG_SPLIT set
                 BlockSize   = uncompressed bytes per block (last may be short)
                 NBytesOrig  = total uncompressed size
                 NBytesComp  = total frame size including header + table
    bytes 16-19  num_blocks (uint32)
    then         num_blocks × uint32 entries:
                 bits 0-30 = compressed payload size of the block
                 bit 31    = block stored memcpy (raw, unshuffled)
    then         concatenated per-block payloads

Each block is filtered (shuffle/bitshuffle) and compressed independently —
blocks are decodable in isolation, so they shard data-parallel across
devices and hosts with only an ordered gather at the end.
"""

from __future__ import annotations

import struct

import numpy as np

from . import filters
from .codecs.registry import get_codec
from .codecs.registry import registry_version as _registry_version
from .codecs.lz4_ref import hc_depth_for_level
from .errors import (
    DataTooLargeError,
    InvalidCodecError,
    InvalidDataError,
    SizeMismatchError,
)
from .format import (
    FLAG_BITSHUFFLE,
    FLAG_SHUFFLE,
    FLAG_SPLIT,
    FORMAT_VERSION,
    HEADER_SIZE,
    MAX_UINT32,
    Codec,
    Header,
    Shuffle,
)
from .options import Options

try:
    from .native import backend as _native
except Exception:  # pragma: no cover - native build failure → pure Python
    _native = None


_resolve_cache: dict = {}


def _native_pipeline_codec(codec: int, level: int) -> tuple[int, int] | None:
    """Memoized dispatch — see _native_pipeline_codec_uncached."""
    key = (codec, level, _registry_version())
    try:
        return _resolve_cache[key]
    except KeyError:
        pass
    if len(_resolve_cache) > 256:  # registry churn (tests); stay bounded
        _resolve_cache.clear()
    result = _native_pipeline_codec_uncached(codec, level)
    _resolve_cache[key] = result
    return result


def _native_pipeline_codec_uncached(codec: int, level: int) -> tuple[int, int] | None:
    """Map a frame codec ID to the native block-pipeline codec + level/depth.

    Level parity with the registered codec wrappers (codecs/standard.py):
    LZ4 ignores level, LZ4HC maps 1-9 to chain depth, ZLIB passes 1-9
    through, ZSTD maps to the reference's four speed tiers
    (codec.go:200-213 → zstd levels 1/3/9/19).

    Returns None — forcing the registry path — when the native backend is
    unavailable OR the user has overridden this builtin codec ID via
    register_codec (their implementation must win).
    """
    if _native is None or not _native.available():
        return None
    from .codecs.standard import is_builtin

    if not is_builtin(codec):
        return None
    if codec == Codec.BLOSCLZ:
        return _native.NATIVE_BLOSCLZ, 1
    if codec == Codec.LZ4:
        return _native.NATIVE_LZ4, 1
    if codec == Codec.LZ4HC:
        return _native.NATIVE_LZ4HC, hc_depth_for_level(level)
    if codec == Codec.SNAPPY:
        return _native.NATIVE_SNAPPY, 0
    if codec == Codec.ZLIB:
        return _native.NATIVE_ZLIB, level
    if codec == Codec.ZSTD and _native.zstd_available():
        zstd_level = 1 if level <= 2 else 3 if level <= 4 else 9 if level <= 6 else 19
        return _native.NATIVE_ZSTD, zstd_level
    return None

_ENTRY_MEMCPY = 0x80000000
_ENTRY_SIZE_MASK = 0x7FFFFFFF

# auto block size: large enough to amortize per-block codec overhead,
# small enough that block + scratch stay L2/L3 resident in the host
# pipeline
DEFAULT_AUTO_BLOCK = 1024 * 1024
MIN_BLOCK = 4096


def choose_block_size(n: int, type_size: int, requested: int = 0) -> int:
    """Pick the block size: requested (if >0) else auto, aligned to 8*ts."""
    align = 8 * max(type_size, 1)
    if requested > 0:
        bs = max(requested, align)
    else:
        bs = DEFAULT_AUTO_BLOCK
        bs = max(min(bs, n), MIN_BLOCK)
    bs = (bs // align) * align
    return max(bs, align)


def split_blocks(raw: bytes, block_size: int) -> list[bytes]:
    return [raw[i : i + block_size] for i in range(0, len(raw), block_size)]


def _filter_block(block: bytes, opts: Options) -> bytes:
    if opts.shuffle == Shuffle.SHUFFLE and opts.type_size > 1:
        return filters.shuffle_bytes(block, opts.type_size).tobytes()
    if opts.shuffle == Shuffle.BITSHUFFLE and opts.type_size > 1:
        return filters.bit_shuffle(block, opts.type_size).tobytes()
    return block


def _unfilter_block(block: bytes, type_size: int, flags: int) -> bytes:
    if flags & FLAG_BITSHUFFLE and type_size > 1:
        return filters.bit_unshuffle(block, type_size).tobytes()
    if flags & FLAG_SHUFFLE and type_size > 1:
        return filters.unshuffle_bytes(block, type_size).tobytes()
    return block


def compress_chunked(raw: bytes, opts: Options) -> bytes:
    """Compress into a multi-block FLAG_SPLIT frame."""
    compressor = get_codec(opts.codec)
    if compressor is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {opts.codec}")

    n = len(raw)
    block_size = choose_block_size(n, opts.type_size, opts.block_size)

    flags = FLAG_SPLIT
    if opts.shuffle == Shuffle.SHUFFLE:
        flags |= FLAG_SHUFFLE
    elif opts.shuffle == Shuffle.BITSHUFFLE:
        flags |= FLAG_BITSHUFFLE

    native = _native_pipeline_codec(opts.codec, opts.level)
    if native is not None:
        # whole-chunk native pipeline: filter + compress every block AND
        # gather the frame in one pass (memcpy fallback handled per block)
        native_codec, depth = native

        def build_prefix(sizes, memcpy_flags):
            nb = len(sizes)
            entries = [
                int(s) | (_ENTRY_MEMCPY if m else 0)
                for s, m in zip(sizes, memcpy_flags)
            ]
            total = (
                HEADER_SIZE + 4 + 4 * nb + int(sizes.sum())
            )
            if total > MAX_UINT32:
                raise DataTooLargeError(
                    f"blosc: data too large: frame of {total} bytes "
                    "exceeds uint32 limit"
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
            return (
                header.to_bytes()
                + struct.pack("<I", nb)
                + struct.pack(f"<{nb}I", *entries)
            )

        return _native.compress_blocks_frame(
            raw, block_size, opts.type_size, int(opts.shuffle),
            native_codec, depth, build_prefix,
            num_threads=opts.num_threads,
        )

    # host/device fallback path (non-native codecs: ZLIB, ZSTD, custom)
    payloads: list[bytes] = []
    entries: list[int] = []
    blocks = split_blocks(raw, block_size)
    # device-batched filter for the full-size blocks when eligible, else
    # per-block host filtering
    shuffled_blocks = _filter_blocks_batched(blocks, opts)
    for raw_block, shuf_block in zip(blocks, shuffled_blocks):
        comp = compressor.compress(shuf_block, opts.level)
        if len(comp) >= len(raw_block):
            payloads.append(raw_block)  # memcpy: raw pre-shuffle bytes
            entries.append(_ENTRY_MEMCPY | len(raw_block))
        else:
            payloads.append(comp)
            entries.append(len(comp))

    num_blocks = len(payloads)
    table = struct.pack("<I", num_blocks) + struct.pack(
        f"<{num_blocks}I", *entries
    )
    total = HEADER_SIZE + len(table) + sum(len(p) for p in payloads)
    if total > MAX_UINT32:
        raise DataTooLargeError(
            f"blosc: data too large: frame of {total} bytes exceeds uint32 limit"
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


def _filter_blocks_batched(blocks: list[bytes], opts: Options) -> list[bytes]:
    """Filter blocks, batching equal-size blocks into one device call."""
    if opts.shuffle == Shuffle.NOSHUFFLE or opts.type_size <= 1 or not blocks:
        return list(blocks)
    bs = len(blocks[0])
    full = [b for b in blocks if len(b) == bs]
    if (
        len(full) > 1
        and filters.device_eligible(bs * len(full), opts.type_size)
        and bs % (8 * opts.type_size) == 0
    ):
        batched = _device_filter_batch(full, bs, opts)
        if batched is not None:
            out = batched
            for b in blocks[len(full) :]:
                out.append(_filter_block(b, opts))
            return out
    return [_filter_block(b, opts) for b in blocks]


def _device_filter_batch(
    full_blocks: list[bytes], bs: int, opts: Options
) -> list[bytes] | None:
    """One device call shuffling all full blocks as a (nb, bs) batch."""
    try:
        from .filters import batched as fb

        arr = np.frombuffer(b"".join(full_blocks), dtype=np.uint8).reshape(
            len(full_blocks), bs
        )
        if opts.shuffle == Shuffle.SHUFFLE:
            out = fb.shuffle_batch(arr, opts.type_size)
        else:
            out = fb.bit_shuffle_batch(arr, opts.type_size)
        return [out[i].tobytes() for i in range(out.shape[0])]
    except Exception:
        return None


def parse_block_table(raw: bytes, header: Header) -> tuple[list[tuple[int, bool]], int]:
    """Return [(payload_size, is_memcpy), ...] and the payload start offset."""
    if len(raw) < HEADER_SIZE + 4:
        raise InvalidDataError("blosc: invalid compressed data: truncated block table")
    (num_blocks,) = struct.unpack_from("<I", raw, HEADER_SIZE)
    table_end = HEADER_SIZE + 4 + 4 * num_blocks
    if num_blocks == 0 or table_end > len(raw) or table_end > header.nbytes_comp:
        raise InvalidDataError("blosc: invalid compressed data: bad block count")
    entries = struct.unpack_from(f"<{num_blocks}I", raw, HEADER_SIZE + 4)
    out = [(e & _ENTRY_SIZE_MASK, bool(e & _ENTRY_MEMCPY)) for e in entries]
    return out, table_end


def _decompress_chunked_native(
    raw: bytes,
    header: Header,
    entries: list[tuple[int, bool]],
    offset: int,
    type_size: int,
    native_codec: int,
    out_addr: int | None = None,
    lo_b: int = 0,
    hi_b: int | None = None,
) -> bytes | int:
    """Native decode of blocks [lo_b, hi_b] (default: the whole chunk).

    Returns the decoded bytes (or, with ``out_addr``, the byte count) and
    raises on any malformed frame.  Full-chunk callers
    (decompress_chunked, decompress_into) get the layout validation here;
    sub-range callers (decompress_block_run, via decompress_range)
    validate the layout once at the range entry point.
    """
    n = header.nbytes_orig
    block_size = header.block_size
    if hi_b is None:
        _validate_block_layout(n, block_size, len(entries))
        hi_b = len(entries) - 1
    sub = entries[lo_b : hi_b + 1]
    psizes = np.array([s for s, _ in sub], dtype=np.int64)
    base = offset + sum(s for s, _ in entries[:lo_b])
    offsets = np.concatenate(
        [[0], np.cumsum(psizes[:-1])]
    ).astype(np.int64) + base
    is_memcpy = np.array([m for _, m in sub], dtype=np.uint8)
    end = int(offsets[-1] + psizes[-1])
    if end > header.nbytes_comp or end > len(raw):
        raise InvalidDataError(
            "blosc: invalid compressed data: block payload overruns frame"
        )
    # memcpy blocks must be exactly block-sized (parity with Python path)
    for k, (psz, m) in enumerate(sub):
        bs = min(block_size, n - (lo_b + k) * block_size)
        if m and psz != bs:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch in memcpy block "
                f"{lo_b + k}"
            )
    cover = min(n, (hi_b + 1) * block_size) - lo_b * block_size
    shuffle_mode = 0
    if header.has_bitshuffle:
        shuffle_mode = 2
    elif header.has_shuffle:
        shuffle_mode = 1
    try:
        return _native.decompress_blocks(
            np.frombuffer(raw, dtype=np.uint8),
            offsets,
            psizes,
            is_memcpy,
            block_size,
            cover,
            type_size,
            shuffle_mode,
            native_codec,
            out_addr=out_addr,
        )
    except Exception:
        from .errors import DecompressionFailedError

        raise DecompressionFailedError(
            "blosc: decompression failed: malformed block payload"
        ) from None


def _validate_block_layout(n: int, block_size: int, num_blocks: int) -> None:
    """Block table must cover nbytes_orig exactly (shared by all decoders)."""
    if block_size == 0:
        raise InvalidDataError("blosc: invalid compressed data: zero block size")
    expected_blocks = -(-n // block_size) if n else 0
    if num_blocks != expected_blocks:
        raise InvalidDataError(
            f"blosc: invalid compressed data: {num_blocks} blocks for "
            f"{n} bytes at block size {block_size}"
        )


def decompress_single_block(
    raw: bytes,
    header: Header,
    entries: list[tuple[int, bool]],
    poff: int,
    bi: int,
    type_size: int,
) -> bytes:
    """Decode ONE block of a FLAG_SPLIT frame — the random-access unit.

    ``entries`` comes from parse_block_table; ``poff`` is block ``bi``'s
    absolute payload offset (callers accumulate it — keeping a range
    decode O(covered blocks), not O(nb) per block).  Callers validate the
    overall layout once (decompress_range does)."""
    n = header.nbytes_orig
    bs = header.block_size
    pos = bi * bs
    this_block = min(bs, n - pos)
    psize, is_memcpy = entries[bi]
    if poff + psize > header.nbytes_comp or poff + psize > len(raw):
        raise InvalidDataError(
            "blosc: invalid compressed data: block payload overruns frame"
        )
    if is_memcpy:
        if psize != this_block:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch in memcpy block {bi}"
            )
        return bytes(raw[poff : poff + psize])
    native = _native_pipeline_codec(header.codec, 1)
    mode = 2 if header.flags & FLAG_BITSHUFFLE else (
        1 if header.flags & FLAG_SHUFFLE else 0
    )
    if native is not None:
        return _native.decompress_frame(
            bytes(raw), poff, psize, this_block, type_size, mode, native[0]
        )
    decompressor = get_codec(header.codec)
    if decompressor is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {header.codec}")
    dec = decompressor.decompress(raw[poff : poff + psize], this_block)
    dec = _unfilter_block(dec, type_size, header.flags)
    if len(dec) != this_block:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: block {bi} got "
            f"{len(dec)}, expected {this_block}"
        )
    return dec


def decompress_block_run(
    raw: bytes,
    header: Header,
    entries: list[tuple[int, bool]],
    offset: int,
    lo_b: int,
    hi_b: int,
    type_size: int,
) -> bytes:
    """Decode blocks [lo_b, hi_b] of a FLAG_SPLIT frame into one bytes.

    The range-decode workhorse: runs of >=4 blocks go through the native
    OpenMP block pipeline (the same parallel path a full decode uses, via
    _decompress_chunked_native's sub-range mode), short runs decode
    block-at-a-time."""
    native = _native_pipeline_codec(header.codec, 1)
    if native is not None and hi_b - lo_b + 1 >= 4:
        return _decompress_chunked_native(
            raw, header, entries, offset, type_size, native[0],
            lo_b=lo_b, hi_b=hi_b,
        )
    parts = []
    poff = offset + sum(s for s, _ in entries[:lo_b])
    for bi in range(lo_b, hi_b + 1):
        parts.append(
            decompress_single_block(raw, header, entries, poff, bi, type_size)
        )
        poff += entries[bi][0]
    return b"".join(parts)


def decompress_chunked(raw: bytes, header: Header, type_size: int) -> bytes:
    """Decompress a FLAG_SPLIT frame."""
    entries, offset = parse_block_table(raw, header)
    if type_size <= 0:
        type_size = header.type_size
    block_size = header.block_size
    n = header.nbytes_orig
    _validate_block_layout(n, block_size, len(entries))

    decompressor = None
    if not all(m for _, m in entries):
        decompressor = get_codec(header.codec)
        if decompressor is None:
            raise InvalidCodecError(f"blosc: unsupported codec: {header.codec}")

    native = _native_pipeline_codec(header.codec, 1)
    if native is not None:
        return _decompress_chunked_native(
            raw, header, entries, offset, type_size, native[0]
        )

    out = bytearray(n)
    pos = 0
    for i, (psize, is_memcpy) in enumerate(entries):
        if offset + psize > header.nbytes_comp or offset + psize > len(raw):
            raise InvalidDataError(
                "blosc: invalid compressed data: block payload overruns frame"
            )
        payload = raw[offset : offset + psize]
        offset += psize
        this_block = min(block_size, n - pos)
        if is_memcpy:
            if psize != this_block:
                raise SizeMismatchError(
                    f"blosc: decompressed size mismatch in memcpy block {i}"
                )
            out[pos : pos + this_block] = payload
        else:
            dec = decompressor.decompress(payload, this_block)
            dec = _unfilter_block(dec, type_size, header.flags)
            if len(dec) != this_block:
                raise SizeMismatchError(
                    f"blosc: decompressed size mismatch: block {i} got "
                    f"{len(dec)}, expected {this_block}"
                )
            out[pos : pos + this_block] = dec
        pos += this_block
    if pos != n:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: got {pos}, expected {n}"
        )
    return bytes(out)
