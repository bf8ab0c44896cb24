"""Public API: compress / decompress / introspection (≙ blosc.go:247-434).

Single-block frames produced here are bit-compatible with the reference's
frame convention; multi-block frames (block_size > 0 or large inputs) are
this library's extension and carry the FLAG_SPLIT bit plus an offset table
(see chunk.py).  Decompress reads both.

One deliberate divergence, required for cross-decoder interop (SURVEY §2.4):
when the memcpy fallback stores raw bytes, we CLEAR the shuffle flags.  The
reference keeps them set (blosc.go:348-356) while storing *pre-shuffle*
bytes, so its own decoder would unshuffle raw bytes into garbage on that
path (latent inconsistency, untested upstream); frames we emit decode
correctly under both decoders.
"""

from __future__ import annotations

import numpy as np

from . import filters
from .codecs.registry import get_codec
from .errors import (
    DataTooLargeError,
    InvalidCodecError,
    InvalidDataError,
    InvalidHeaderError,
    SizeMismatchError,
)
from .format import (
    FLAG_BITSHUFFLE,
    FLAG_MEMCPY,
    FLAG_SHUFFLE,
    FLAG_SPLIT,
    FORMAT_VERSION,
    HEADER_SIZE,
    MAX_UINT32,
    Codec,
    Header,
    Shuffle,
    parse_header,
)
from .options import Options

import struct

_HDR_TAIL = struct.Struct("<III")  # nbytes_orig, block_size, nbytes_comp

# imported for registration side effect
from .codecs import standard as _standard  # noqa: F401

# hot-path modules bound once (per-call `from . import x` costs ~1us each,
# which matters at the reference's 100 KB benchmark point)
from . import chunk as _chunk

try:
    from .native import backend as _nb
except Exception:  # pragma: no cover - native build failure → pure Python
    _nb = None

# Inputs above this auto-switch to multi-block frames (chunk.py); the
# reference has no such threshold (always single block, blosc.go:364).
AUTO_BLOCK_THRESHOLD = 4 * 1024 * 1024


def _coerce_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, np.ndarray):
        return data.tobytes()
    raise TypeError(f"expected bytes-like or ndarray, got {type(data)!r}")


def _cached_options(codec, level, shuffle, type_size) -> Options:
    # Options is frozen, so identical positional combos can share one
    # instance — the dataclass init is ~10% of a 100 KB compress call.
    key = (codec, level, shuffle, type_size)
    opts = _OPTIONS_CACHE.get(key)
    if opts is None:
        opts = Options(
            codec=codec, level=level, shuffle=shuffle, type_size=type_size
        )
        if len(_OPTIONS_CACHE) < 256:
            _OPTIONS_CACHE[key] = opts
    return opts


# Memoized jump table for the positional-args compress() hot path: maps
# (codec, level, shuffle, type_size) straight to the single-shot native
# frame call, skipping the wrapper chain (compress_with_options →
# _compress_frame_sized → _compress_single_block → backend.compress_frame
# ≈ 2-3 us — a third of a 100 KB call).  Entries pin the registry version
# so register_codec overrides invalidate them; everything unusual
# (non-bytes input, empty, > AUTO_BLOCK_THRESHOLD, no native path) falls
# through to the full path, which owns clamping, errors, and containers.
_FAST_LANE: dict = {}


def _prime_fast_lane(key) -> None:
    if len(_FAST_LANE) > 256:
        _FAST_LANE.clear()  # registry churn (tests); stay bounded
    rv = _chunk._registry_version()
    entry = (rv, None)  # "no fast path at this registry version"
    if _nb is not None and _nb.available():
        opts = _cached_options(*key).clamped()
        if opts.block_size == 0:
            native = _chunk._native_pipeline_codec(int(opts.codec), opts.level)
            if native is not None:
                fn = _nb._fast.compress_frame if _nb._fast is not None \
                    else _nb.compress_frame
                entry = (
                    rv, fn, opts.type_size, int(opts.shuffle),
                    int(opts.codec), native[0], native[1],
                )
    _FAST_LANE[key] = entry


def compress(
    data,
    codec: Codec = Codec.LZ4,
    level: int = 5,
    shuffle: Shuffle = Shuffle.SHUFFLE,
    type_size: int = 4,
) -> bytes:
    """Compress data into a Blosc frame (≙ Compress, blosc.go:257-265)."""
    key = (codec, level, shuffle, type_size)
    fl = _FAST_LANE.get(key)
    if fl is None or fl[0] != _chunk._registry_version():
        _prime_fast_lane(key)
        fl = _FAST_LANE.get(key)
    if (
        fl is not None
        and fl[1] is not None
        and type(data) is bytes
        and 0 < len(data) <= AUTO_BLOCK_THRESHOLD
    ):
        return fl[1](data, fl[2], fl[3], fl[4], fl[5], fl[6])
    return compress_with_options(
        data, _cached_options(codec, level, shuffle, type_size)
    )


_OPTIONS_CACHE: dict = {}


# Inputs above this are split into a 64-bit super-frame container of
# independent sub-frames (container.py); leaves headroom under the uint32
# frame cap for the block table and incompressible payloads.
FRAME_SAFE_LIMIT = MAX_UINT32 - (64 << 20)


def _coerce_flat(data):
    """Flat byte view of the input — zero-copy when possible.

    Contiguous ndarrays and memoryviews flow through the compress
    pipeline as flat uint8 memoryviews (the native paths read them via
    the buffer protocol / np.frombuffer), so an array input pays no
    ``tobytes()`` staging copy — on this VM that copy can cost more than
    the compression itself.  Non-contiguous inputs still flatten to
    bytes, matching ``tobytes()``'s C-order semantics.
    """
    if isinstance(data, (bytes, bytearray)):
        return data
    if isinstance(data, memoryview):
        return data.cast("B") if data.contiguous else bytes(data)
    if isinstance(data, np.ndarray):
        try:
            return memoryview(data).cast("B")
        except (TypeError, BufferError, ValueError):
            # non-contiguous, or a dtype the buffer protocol refuses
            # (datetime/bfloat16/...) — flatten like tobytes always did
            return data.tobytes()
    raise TypeError(f"expected bytes-like or ndarray, got {type(data)!r}")


def compress_with_options(data, opts: Options) -> bytes:
    """≙ CompressWithOptions (blosc.go:268-286): reject empty, clamp, compress.

    Inputs past the uint32 frame cap (which the reference silently
    truncates through, blosc.go:362-365) route to the 64-bit super-frame
    container — see container.py.
    """
    raw = _coerce_flat(data)
    if len(raw) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    opts = opts.clamped()
    if len(raw) + HEADER_SIZE > FRAME_SAFE_LIMIT:
        from . import container

        return container.compress_container(raw, opts)
    return _compress_frame_sized(raw, opts)


def _compress_frame_sized(raw: bytes, opts: Options) -> bytes:
    """Compress data already known to fit a single uint32-framed chunk."""
    if len(raw) + HEADER_SIZE > MAX_UINT32:
        raise DataTooLargeError(
            f"blosc: data too large: {len(raw)} bytes exceeds uint32 frame limit"
        )
    if opts.block_size > 0 or len(raw) > AUTO_BLOCK_THRESHOLD:
        from . import chunk

        return chunk.compress_chunked(raw, opts)
    return _compress_single_block(raw, opts)


def _compress_single_block(raw: bytes, opts: Options) -> bytes:
    """Single-block pipeline (≙ compressBackend, blosc.go:319-374)."""
    compressor = get_codec(opts.codec)
    if compressor is None:
        raise InvalidCodecError(f"blosc: unsupported codec: {opts.codec}")

    # Single-shot native path: filter + codec + memcpy fallback + header in
    # one C call (tpb_compress_frame).  This is what the reference's own
    # 100 KB benchmark point measures (blosc_test.go:363-413); collapsing
    # the four ctypes crossings is worth ~2x there.  Memoryview inputs
    # (zero-copy array/container slices) pass straight through — the
    # binding reads them via the buffer protocol.
    native = _chunk._native_pipeline_codec(opts.codec, opts.level)
    if native is not None:
        return _nb.compress_frame(
            raw, opts.type_size, int(opts.shuffle),
            int(opts.codec), native[0], native[1],
        )

    if isinstance(raw, memoryview):  # python codecs/filters want bytes
        raw = bytes(raw)
    shuffled = raw
    if opts.shuffle == Shuffle.SHUFFLE and opts.type_size > 1:
        shuffled = filters.shuffle_bytes(raw, opts.type_size).tobytes()
    elif opts.shuffle == Shuffle.BITSHUFFLE and opts.type_size > 1:
        shuffled = filters.bit_shuffle(raw, opts.type_size).tobytes()

    compressed = compressor.compress(shuffled, opts.level)

    use_memcpy = len(compressed) >= len(raw)
    if use_memcpy:
        compressed = raw  # store untouched input (blosc.go:342-345)

    flags = 0
    if use_memcpy:
        # interop divergence: shuffle flags cleared (see module docstring)
        flags |= FLAG_MEMCPY
    elif opts.shuffle == Shuffle.SHUFFLE:
        flags |= FLAG_SHUFFLE
    elif opts.shuffle == Shuffle.BITSHUFFLE:
        flags |= FLAG_BITSHUFFLE

    header = Header(
        version=FORMAT_VERSION,
        version_lz=int(opts.codec),
        flags=flags,
        type_size=min(opts.type_size, 255),
        nbytes_orig=len(raw),
        block_size=len(raw),  # single block (blosc.go:364)
        nbytes_comp=HEADER_SIZE + len(compressed),
    )
    return header.to_bytes() + compressed


def compress_batch(
    items,
    codec: Codec = Codec.LZ4,
    level: int = 5,
    shuffle: Shuffle = Shuffle.SHUFFLE,
    type_size: int = 4,
) -> list[bytes]:
    """Compress many independent inputs, one Blosc frame each.

    Semantically identical to ``[compress(x, ...) for x in items]`` —
    same frames, byte for byte — but executed through one native binding
    crossing: frames below the segment-parallel floor are scheduled
    whole-frame across the SpinPool (a 100 KB frame is a ~10 µs work
    unit, well above this host's vCPU stall noise, so small frames scale
    across cores even though each alone stays serial), and larger frames
    take their normal internally-parallel path.  The reference has no
    batch surface (one frame per call, blosc.go:257-265); this is the
    host analogue of mapping the codec data-parallel over a mesh.
    """
    return compress_batch_with_options(
        items, _cached_options(codec, level, shuffle, type_size)
    )


def _coerce_buffer(item):
    """Zero-copy C-contiguous buffer view of a batch item.

    The batch fast path reads items through the buffer protocol
    (PyObject_GetBuffer in fastmod.c), so contiguous ndarrays and
    memoryviews need no ``tobytes()`` staging copy — on checkpoint-style
    workloads that copy costs more than the compression itself (this
    VM's ~50 µs page faults).  Non-contiguous inputs still flatten.
    """
    if isinstance(item, (bytes, bytearray)):
        return item
    if isinstance(item, memoryview):
        return item if item.contiguous else bytes(item)
    if isinstance(item, np.ndarray):
        if item.dtype == object:
            raise TypeError("object arrays cannot be compressed")
        return item if item.flags.c_contiguous else np.ascontiguousarray(item)
    raise TypeError(f"expected bytes-like or ndarray, got {type(item)!r}")


def _buffer_nbytes(buf) -> int:
    return buf.nbytes if isinstance(buf, (np.ndarray, memoryview)) else len(buf)


def compress_batch_with_options(items, opts: Options) -> list[bytes]:
    """Batch form of compress_with_options; output bytes are identical."""
    raws = []
    for i, item in enumerate(items):
        raw = _coerce_buffer(item)
        if _buffer_nbytes(raw) == 0:
            raise InvalidDataError(
                f"blosc: invalid compressed data: empty input (batch item {i})"
            )
        raws.append(raw)
    opts = opts.clamped()
    native = _chunk._native_pipeline_codec(opts.codec, opts.level)
    if native is None or opts.block_size > 0:
        return [compress_with_options(r, opts) for r in raws]
    # items beyond the single-block regime keep their scalar path
    # (multi-block chunking / 64-bit container) — they parallelize
    # internally; the native batch takes everything else in one call.
    fast_idx = [
        i for i, r in enumerate(raws)
        if _buffer_nbytes(r) <= AUTO_BLOCK_THRESHOLD
    ]
    out: list = [None] * len(raws)
    if fast_idx:
        frames = _nb.compress_frames(
            [raws[i] for i in fast_idx], opts.type_size, int(opts.shuffle),
            int(opts.codec), native[0], native[1],
        )
        for i, frame in zip(fast_idx, frames):
            out[i] = frame
    for i, r in enumerate(raws):
        if out[i] is None:
            out[i] = compress_with_options(r, opts)
    return out


def decompress_batch(items, type_size: int = 0) -> list[bytes]:
    """Decompress many frames; ``[decompress_with_size(x, ts) for x in items]``.

    Plain single-block native-codec frames decode through one binding
    crossing with whole small frames scheduled across the SpinPool (the
    headers are parsed natively, so the per-item Python cost is gone).
    Anything else — containers, multi-block frames, memcpy frames,
    user-registered codecs, malformed input — falls back to the scalar
    path per item, which owns every typed error; errors therefore match
    the scalar API exactly and abort on the first offending item.
    """
    raws = [_coerce_bytes(x) for x in items]
    native_map = _decode_native_map()
    if _nb is not None and native_map is not None:
        out = _nb.decompress_frames(raws, type_size, native_map)
    else:
        out = [None] * len(raws)
    for i, r in enumerate(out):
        if r is None:
            out[i] = decompress_with_size(raws[i], type_size)
    return out


def _decode_native_map() -> bytes | None:
    """Header-codec-id -> native-codec-id table for the C batch decoders.

    0xFF marks ids that must take the Python path (unknown codec, user
    registry override, native unavailable); None means nothing is
    natively decodable at all (skip the native call entirely).
    """
    native_map = bytes(
        (_chunk._native_pipeline_codec(cid, 1) or (0xFF,))[0]
        for cid in range(6)
    )
    return None if native_map == b"\xff" * 6 else native_map


def decompress_batch_into(items, outs) -> list[int]:
    """Batch form of decompress_into: decode each frame into ``outs[i]``.

    Returns the per-item byte counts.  Eligible plain single-block frames
    decode natively straight into the caller buffers (no intermediate
    bytes object — the zero-copy path checkpoint loading uses); anything
    else falls back to the scalar decompress_into per item, which owns
    the typed errors (undersized buffer, malformed frame, ...).

    Error side effects differ from a scalar loop in one way: the batch
    decodes eligible items before the fallback pass, so when an earlier
    item raises, LATER outs may already hold decoded data (a scalar loop
    would not have reached them).  Buffer contents are only defined for
    items before the first failure.
    """
    raws = [_coerce_bytes(x) for x in items]
    outs = list(outs)
    if len(raws) != len(outs):
        raise ValueError(
            f"outs length {len(outs)} must match items length {len(raws)}"
        )
    native_map = _decode_native_map()
    if _nb is not None and native_map is not None:
        res = _nb.decompress_frames_into(raws, outs, native_map)
    else:
        res = [None] * len(raws)
    for i, r in enumerate(res):
        if r is None:
            res[i] = decompress_into(raws[i], outs[i])
    return res


def decompress(data) -> bytes:
    """Decompress a Blosc frame (≙ Decompress, blosc.go:291-293)."""
    return decompress_with_size(data, 0)


def decompress_with_size(data, type_size: int) -> bytes:
    """≙ DecompressWithSize (blosc.go:296-303) + decompressBackend (377-434)."""
    raw = _coerce_bytes(data)
    # Hot-path header parse without the Header object (~1.6 us of a ~10 us
    # single-block decode): engage only for plain well-formed native-codec
    # single-block frames; anything unusual falls through to the full path
    # below, which owns every error message and the registry override.
    if len(raw) > HEADER_SIZE and raw[0] == FORMAT_VERSION:
        codec_id, flags, ts_hdr = raw[1], raw[2], raw[3]
        if not flags & (FLAG_SPLIT | FLAG_MEMCPY):
            n_orig, _bs, n_comp = _HDR_TAIL.unpack_from(raw, 4)
            if HEADER_SIZE < n_comp <= len(raw) and n_orig > 0:
                native = _chunk._native_pipeline_codec(codec_id, 1)
                if native is not None:
                    return _nb.decompress_frame(
                        raw, HEADER_SIZE, n_comp - HEADER_SIZE, n_orig,
                        type_size if type_size > 0 else ts_hdr,
                        2 if flags & FLAG_BITSHUFFLE
                        else 1 if flags & FLAG_SHUFFLE else 0,
                        native[0],
                    )
    if len(raw) >= 4 and raw[:4] == b"TPB2":
        from . import container

        return container.decompress_container(raw, type_size)
    if len(raw) < HEADER_SIZE:
        raise InvalidHeaderError(
            f"blosc: invalid header: need {HEADER_SIZE} bytes, got {len(raw)}"
        )
    header = parse_header(raw)

    if header.nbytes_comp > len(raw):
        raise InvalidDataError(
            "blosc: invalid compressed data: header claims "
            f"{header.nbytes_comp} bytes, only {len(raw)} present"
        )
    if header.nbytes_comp < HEADER_SIZE:
        raise InvalidDataError(
            "blosc: invalid compressed data: NBytesComp below header size"
        )

    if header.is_split:
        from . import chunk

        return chunk.decompress_chunked(raw, header, type_size)

    # Single-shot native path for non-memcpy frames: codec decode +
    # unfilter straight into the result bytes in one C call.
    if not header.is_memcpy:
        native = _chunk._native_pipeline_codec(header.codec, 1)
        if native is not None:
            ts = type_size if type_size > 0 else header.type_size
            mode = (
                2 if header.has_bitshuffle
                else 1 if header.has_shuffle
                else 0
            )
            return _nb.decompress_frame(
                raw, HEADER_SIZE, header.nbytes_comp - HEADER_SIZE,
                header.nbytes_orig, ts, mode, native[0],
            )

    payload = raw[HEADER_SIZE : header.nbytes_comp]

    if header.is_memcpy:
        decompressed = payload
    else:
        decompressor = get_codec(header.codec)
        if decompressor is None:
            raise InvalidCodecError(
                f"blosc: unsupported codec: {Codec(header.codec) if header.codec < 6 else header.codec}"
            )
        decompressed = decompressor.decompress(payload, header.nbytes_orig)

    if type_size <= 0:
        type_size = header.type_size

    # reference order: unshuffle runs even on memcpy frames (blosc.go:398-426)
    if header.has_bitshuffle and type_size > 1:
        decompressed = filters.bit_unshuffle(decompressed, type_size).tobytes()
    elif header.has_shuffle and type_size > 1:
        decompressed = filters.unshuffle_bytes(decompressed, type_size).tobytes()
    elif not isinstance(decompressed, bytes):
        decompressed = bytes(decompressed)

    if len(decompressed) != header.nbytes_orig:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: got {len(decompressed)}, "
            f"expected {header.nbytes_orig}"
        )
    return decompressed


def decompress_range(data, start: int, size: int, type_size: int = 0) -> bytes:
    """Decompress only bytes ``[start, start+size)`` of a frame.

    Random access into compressed data — what the multi-block layout is
    for: FLAG_SPLIT frames decode ONLY the blocks covering the range, and
    TPB2 containers additionally skip whole sub-frames, so reading a slice
    of a huge container costs O(covered blocks).  Single-block frames have
    one codec stream and necessarily decode fully before slicing (the
    reference's only layout, blosc.go:364).  The reference has no range
    API at all.

    ``start``/``size`` must lie within the decompressed size; ``size`` of
    0 returns b"".  ``type_size`` overrides the header's filter element
    size like decompress_with_size.
    """
    raw = _coerce_bytes(data)
    if start < 0 or size < 0:
        raise InvalidDataError(
            "blosc: invalid compressed data: negative range"
        )

    if len(raw) >= 4 and raw[:4] == b"TPB2":
        from . import container as _container

        _, _, _, _, total, sizes, off = _container.parse_container(raw)
        # the shared validated walk: bounds + total-vs-headers cross-check
        spans = _container.frame_spans(memoryview(raw), total, sizes, off)
        if start + size > total:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch: range "
                f"[{start}, {start + size}) outside {total} bytes"
            )
        if size == 0:
            return b""
        parts = []
        pos = 0
        for fpos, fs, n_sub in spans:
            lo = max(start, pos)
            hi = min(start + size, pos + n_sub)
            if lo < hi:
                parts.append(
                    decompress_range(
                        raw[fpos : fpos + fs], lo - pos, hi - lo, type_size
                    )
                )
            pos += n_sub
            if pos >= start + size:
                break
        return b"".join(parts)

    if len(raw) < HEADER_SIZE:
        raise InvalidHeaderError(
            f"blosc: invalid header: need {HEADER_SIZE} bytes, got {len(raw)}"
        )
    header = parse_header(raw)
    if header.nbytes_comp > len(raw) or header.nbytes_comp < HEADER_SIZE:
        raise InvalidDataError(
            "blosc: invalid compressed data: bad NBytesComp"
        )
    n = header.nbytes_orig
    if start + size > n:
        raise SizeMismatchError(
            f"blosc: decompressed size mismatch: range "
            f"[{start}, {start + size}) outside {n} bytes"
        )
    if size == 0:
        return b""
    ts = type_size if type_size > 0 else header.type_size

    if header.is_split:
        from . import chunk

        entries, offset = parse_block_table_checked(raw, header)
        bs = header.block_size
        lo_b = start // bs
        hi_b = (start + size - 1) // bs
        blob = chunk.decompress_block_run(
            raw, header, entries, offset, lo_b, hi_b, ts
        )
        rel = start - lo_b * bs
        if rel == 0 and size == len(blob):  # block-aligned: no slice copy
            return blob
        return blob[rel : rel + size]

    # single-block frame: one codec stream — decode fully, then slice
    return decompress_with_size(raw, type_size)[start : start + size]


def decompress_range_into(data, start: int, size: int, out,
                          type_size: int = 0) -> int:
    """decompress_range straight into a caller buffer; returns ``size``.

    The zero-copy range read for data-loader hot paths: on FLAG_SPLIT
    frames, interior covering blocks decode natively straight into
    ``out`` (the same out_addr pipeline decompress_into uses) and only
    the unaligned edge blocks pay an intermediate copy.  Other layouts
    (containers, single-block frames) decode via decompress_range and
    copy once.
    """
    raw = _coerce_bytes(data)
    view = _writable_u8_view(out)
    if size > view.size:
        raise InvalidDataError(
            f"blosc: output buffer too small: need {size}, have {view.size}"
        )
    if (
        len(raw) >= HEADER_SIZE
        and raw[:4] != b"TPB2"
        and (parse_header(raw)).is_split
    ):
        header = parse_header(raw)
        if header.nbytes_comp > len(raw) or header.nbytes_comp < HEADER_SIZE:
            raise InvalidDataError(
                "blosc: invalid compressed data: bad NBytesComp"
            )
        n = header.nbytes_orig
        if start < 0 or size < 0:
            raise InvalidDataError(
                "blosc: invalid compressed data: negative range"
            )
        if start + size > n:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch: range "
                f"[{start}, {start + size}) outside {n} bytes"
            )
        if size == 0:
            return 0
        from . import chunk

        entries, offset = parse_block_table_checked(raw, header)
        ts = type_size if type_size > 0 else header.type_size
        bs = header.block_size
        lo_b, hi_b = start // bs, (start + size - 1) // bs
        native = chunk._native_pipeline_codec(header.codec, 1)
        # interior run = the fully-covered blocks; decode those straight
        # into out, and the (at most two) partial edge blocks via bytes
        in_lo = lo_b + (1 if start % bs else 0)
        in_hi = hi_b - (1 if (start + size) % bs and (start + size) < n else 0)
        if native is not None and in_hi - in_lo + 1 >= 4:
            dst0 = in_lo * bs - start  # offset of the interior run in out
            chunk._decompress_chunked_native(
                raw, header, entries, offset, ts, native[0],
                out_addr=int(view.ctypes.data) + dst0,
                lo_b=in_lo, hi_b=in_hi,
            )
            poff = offset + sum(s for s, _ in entries[:lo_b])
            if in_lo > lo_b:  # leading partial block
                blob = chunk.decompress_single_block(
                    raw, header, entries, poff, lo_b, ts
                )
                rel = start - lo_b * bs
                view[: len(blob) - rel] = np.frombuffer(
                    blob, dtype=np.uint8
                )[rel:]
            if in_hi < hi_b:  # trailing partial block
                poff_hi = offset + sum(s for s, _ in entries[:hi_b])
                blob = chunk.decompress_single_block(
                    raw, header, entries, poff_hi, hi_b, ts
                )
                take = (start + size) - hi_b * bs
                view[size - take : size] = np.frombuffer(
                    blob, dtype=np.uint8
                )[:take]
            return size
    blob = decompress_range(raw, start, size, type_size)
    view[:size] = np.frombuffer(blob, dtype=np.uint8)
    return size


def parse_block_table_checked(raw: bytes, header):
    """Block table + layout validation in one step (range-decode entry)."""
    from . import chunk

    entries, offset = chunk.parse_block_table(raw, header)
    chunk._validate_block_layout(
        header.nbytes_orig, header.block_size, len(entries)
    )
    return entries, offset


def _writable_u8_view(out) -> np.ndarray:
    """A writable flat uint8 view over a caller buffer (no copy)."""
    if isinstance(out, np.ndarray):
        if not out.flags.writeable or not out.flags.c_contiguous:
            raise TypeError("out array must be writable and contiguous")
        return out.reshape(-1).view(np.uint8)
    view = np.frombuffer(out, dtype=np.uint8)  # bytearray/writable memoryview
    if not view.flags.writeable:
        raise TypeError("out buffer must be writable")
    return view


def decompress_into(data, out) -> int:
    """Decompress into a caller-provided buffer; returns bytes written.

    ``out`` is a bytearray, writable memoryview, or contiguous ndarray.
    For chunked frames with natively-covered codecs the blocks decode
    straight into ``out`` (no intermediate allocation) — the zero-copy
    analogue of pre-allocating with GetDecompressedSize (blosc.go:311-317).
    """
    raw = _coerce_bytes(data)
    n = get_decompressed_size(raw)
    view = _writable_u8_view(out)
    if view.size < n:
        raise InvalidDataError(
            f"blosc: output buffer too small: need {n}, have {view.size}"
        )

    if len(raw) >= 4 and raw[:4] == b"TPB2":
        from . import container

        pos = 0
        _, _, _, _, total, sizes, offset = container.parse_container(raw)
        fpos = offset
        for fs in sizes:
            pos += decompress_into(raw[fpos : fpos + fs], view[pos:])
            fpos += fs
        return pos

    header = parse_header(raw)
    # same frame-size validation as decompress/decompress_with_size —
    # the native split shortcut below must not ACCEPT frames the
    # canonical path rejects (fuzz-caught divergence)
    if header.nbytes_comp > len(raw):
        raise InvalidDataError(
            "blosc: invalid compressed data: header claims "
            f"{header.nbytes_comp} bytes, only {len(raw)} present"
        )
    if header.nbytes_comp < HEADER_SIZE:
        raise InvalidDataError(
            "blosc: invalid compressed data: NBytesComp below header size"
        )
    if header.is_split:
        from . import chunk

        native = chunk._native_pipeline_codec(header.codec, 1)
        if native is not None:
            entries, offset = chunk.parse_block_table(raw, header)
            # _decompress_chunked_native validates the block layout (count
            # vs nbytes_orig/block_size) and raises on malformed frames, so
            # a truncated block table can't leave the tail of `out` stale.
            return chunk._decompress_chunked_native(
                raw, header, entries, offset, header.type_size, native[0],
                out_addr=int(view.ctypes.data),
            )
    elif not header.is_memcpy and _nb is not None:
        # plain single-block frame: decode + unfilter straight into the
        # caller buffer through the batch-into fastcall (no intermediate
        # bytes object); ineligible/failed items fall through below
        native_map = _decode_native_map()
        if native_map is not None:
            res = _nb.decompress_frames_into([raw], [view[:n]], native_map)
            if res[0] == n:
                return n

    view[:n] = np.frombuffer(decompress_with_size(raw, 0), dtype=np.uint8)
    return n


def _probe_sample(raw: bytes, sample_bytes: int, type_size: int) -> bytes:
    """Strided multi-window advisor sample spanning the WHOLE input.

    A prefix-only sample mis-advises heterogeneous data (a structured
    header followed by noise steers every decision off the first 4 MiB);
    eight evenly spaced windows cover the full buffer, each aligned to
    type_size so the filters still see element boundaries.
    """
    if len(raw) <= sample_bytes:
        return raw
    ts = max(type_size, 1)
    k = 8
    win = max(sample_bytes // k // ts * ts, ts)
    stride = max((len(raw) - win) // (k - 1) // ts * ts, win)
    parts = [raw[i * stride : i * stride + win] for i in range(k)]
    return b"".join(p for p in parts if p)


def probe_stats(sample: bytes) -> dict:
    """The advisor's compressibility statistics of one (filtered) sample.

    Returns {"run_fraction", "mean_byte", "n"}: the share of adjacent
    byte pairs that are equal (high: RLE-like data where LZ4 excels),
    the mean byte value, and the sample length.  A run_fraction near
    1/256 with a mean near 127.5 reads as incompressible.
    """
    a = np.frombuffer(sample, dtype=np.uint8)
    return {
        "run_fraction": _run_fraction(a),
        "mean_byte": float(a.mean()) if a.size else 0.0,
        "n": a.size,
    }


def suggest_codec(data, type_size: int = 4, sample_bytes: int = 1 << 22) -> Codec:
    """Recommend a codec from a one-pass compressibility probe.

    Probes a strided whole-input sample *after* byte-shuffling (what the
    codec will actually see): run-dominated data → LZ4 (speed wins,
    matches are cheap), moderate structure → ZSTD (entropy coding pays
    off), near-random → LZ4 (fast path; its memcpy fallback makes the
    cost of being wrong one cheap pass).  The sample is on the host, so
    the statistics are NumPy passes (probe_stats).
    """
    raw = _probe_sample(_coerce_bytes(data), sample_bytes, type_size)
    if len(raw) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    if type_size > 1 and len(raw) >= type_size:
        raw = filters.shuffle_bytes(raw, type_size).tobytes()

    rf = probe_stats(raw)["run_fraction"]
    if rf >= 0.30:
        return Codec.LZ4  # run-dominated: match copies at memory speed
    if rf >= 0.02:
        return Codec.ZSTD  # structured but not run-heavy: entropy coding
    return Codec.LZ4  # near-random: fastest attempt, memcpy fallback


def _run_fraction(sample: np.ndarray) -> float:
    pairs = max(sample.size - 1, 1)
    return float(np.count_nonzero(sample[1:] == sample[:-1])) / pairs


def suggest_options(data, type_size: int = 4,
                    sample_bytes: int = 1 << 22) -> Options:
    """Recommend full Options — filter AND codec — from one probe pass.

    Filter choice is the bigger lever than codec choice on numeric data
    (the 16 MiB f32 profile in BASELINE.md shows bitshuffle forcing a
    14-byte match ceiling where byte shuffle runs 22 GB/s): the probe
    compares the post-filter run structure of a sample under no filter,
    byte shuffle, and bit shuffle, picks the filter whose output is most
    run-friendly, then picks the codec for that stream the same way
    suggest_codec does.  One O(sample) pass per filter; the result is
    a starting point, not a guarantee.
    """
    raw = _probe_sample(_coerce_bytes(data), sample_bytes, type_size)
    if len(raw) == 0:
        raise InvalidDataError("blosc: invalid compressed data: empty input")
    type_size = type_size if type_size > 0 else 1

    a = np.frombuffer(raw, dtype=np.uint8)
    candidates: list[tuple[float, Shuffle, np.ndarray]] = [
        (_run_fraction(a), Shuffle.NOSHUFFLE, a)
    ]
    if type_size > 1 and len(raw) >= 8 * type_size:
        sh = filters.shuffle_bytes(raw, type_size)
        candidates.append((_run_fraction(sh), Shuffle.SHUFFLE, sh))
        bit = filters.bit_shuffle(raw, type_size)
        candidates.append((_run_fraction(bit), Shuffle.BITSHUFFLE, bit))

    # prefer the filter with the most run structure; byte shuffle wins
    # ties (cheapest filter, longest matches — see the bitshuffle profile)
    order = {Shuffle.SHUFFLE: 0, Shuffle.NOSHUFFLE: 1, Shuffle.BITSHUFFLE: 2}
    best_rf, best_mode, best_stream = max(
        candidates, key=lambda c: (c[0], -order[c[1]])
    )

    rf = best_rf
    if rf >= 0.30:
        codec = Codec.LZ4
    elif rf >= 0.02:
        codec = Codec.ZSTD
    else:
        codec = Codec.LZ4
    return Options(codec=codec, shuffle=best_mode, type_size=type_size)


def get_info(data):
    """≙ GetInfo (blosc.go:306-308): parse header without decompressing.

    Returns a Header for Blosc frames; for super-frame containers returns
    a container.ContainerInfo (codec/flags/type_size/total/frame count).
    """
    raw = _coerce_bytes(data)
    if len(raw) >= 4 and raw[:4] == b"TPB2":
        from . import container

        return container.get_container_info(raw)
    return parse_header(raw)


def get_decompressed_size(data) -> int:
    """≙ GetDecompressedSize (blosc.go:311-317); container-aware."""
    raw = _coerce_bytes(data)
    if len(raw) >= 4 and raw[:4] == b"TPB2":
        from . import container

        return container.parse_container(raw)[4]
    return parse_header(raw).nbytes_orig
