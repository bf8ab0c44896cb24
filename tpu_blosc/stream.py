"""Streaming file API: appendable on-disk sequences of Blosc frames.

The reference is a one-shot in-memory API with no file/streaming layer at
all (SURVEY §5: no checkpoint/IO subsystem) — this is the device-side
data-loader story the round-1 verdict listed as the stretch item: write
compressed records incrementally (activations, dataset shards, checkpoint
pieces), reopen to append, read back by index or by iteration, optionally
straight onto a device.

File layout (all little-endian):

    bytes 0-3   magic b"TPBS"
    byte  4     stream version = 1
    byte  5     flags: bit 0 = records carry a trailing crc32
    bytes 6-7   reserved (zero)
    then        repeated records: uint64 frame_len, frame bytes,
                [uint32 crc32 of the frame bytes when flag bit 0 is set]
                (each frame is any payload decompress() accepts: a plain
                frame, a FLAG_SPLIT chunked frame, or a TPB2 container)
    footer      uint64 count, count x uint64 record offsets,
                uint64 index_size_bytes, magic b"TPBI"

Checksums (``StreamWriter(..., checksum=True)``) are the integrity story
for checkpoints: a flipped bit inside a compressed payload can decode to
plausible garbage of the right length (LZ-family streams have no internal
redundancy), and the crc32 catches it at read time.  The flag is a
whole-stream property; appending adopts whatever the file was created
with.

The footer makes ``StreamReader`` O(1) random access; a file whose footer
is missing or corrupt (e.g. a crashed writer) still opens — the reader
falls back to a sequential scan of the length-prefixed records, which is
also how appending re-opens a footer-less file.  Appending truncates the
footer and continues writing records; close() rewrites it.

Usage:

    with StreamWriter(path) as w:
        w.write(chunk_bytes)              # host bytes
        w.write_array(jax_array)          # device array (filter on device)
    with StreamReader(path) as r:
        data = r.read(0)
        arr = r.read_array(1, np.float32, shape=(n,))
        for chunk in r: ...
"""

from __future__ import annotations

import os
import struct
import threading


from .errors import (
    BloscError,
    DecompressionFailedError,
    InvalidCodecError,
    InvalidDataError,
    InvalidHeaderError,
    SizeMismatchError,
)
from .options import Options

MAGIC = b"TPBS"
FOOTER_MAGIC = b"TPBI"
STREAM_VERSION = 1
HEADER_SIZE = 8

# Dictionary records (stream-level feature, one dict per stream):
#   definition record: b"TPBD" 0x00 <zstd dict bytes>
#   payload record:    b"TPBD" 0x01 <uint64 orig_size> <zstd dict-compressed>
# Definition records live in the data region but are excluded from the
# logical record index; payload records decode only via the stream API
# (the core decompress() doesn't know the dict).
DICT_MAGIC = b"TPBD"
_DICT_DEF = 0
_DICT_PAYLOAD = 1


_FLAG_CRC = 0x1


def _pack_header(flags: int = 0) -> bytes:
    return MAGIC + bytes([STREAM_VERSION, flags, 0, 0])


def _zstandard():
    """python-zstandard, which dictionary records need: the native
    runtime's libzstd serves plain ZSTD frames but not dictionaries."""
    try:
        import zstandard
    except ImportError as exc:
        raise InvalidCodecError(
            "blosc: zstd dictionary streams need the zstandard module, "
            "which is not installed"
        ) from exc
    return zstandard


class StreamWriter:
    """Append compressed records to a stream file.

    ``opts`` are the default compression options for write()/write_array();
    per-call overrides accepted.  Pass ``append=True`` to continue an
    existing stream (its footer is dropped and rewritten on close).

    Dictionary mode (many-small-record streams): pass ``train_dict=N`` to
    buffer the first N write() payloads, train a zstd dictionary on them,
    and compress them (and every later record) against it — typically a
    large ratio win for few-KB records that share structure.  Or pass a
    pre-trained ``dictionary`` (bytes).  One dictionary per stream;
    dictionary records decode through StreamReader (the core decompress()
    has no dict).  write_frame()/write_array() always store plain frames.
    """

    def __init__(self, path, opts: Options | None = None, append: bool = False,
                 dictionary: bytes | None = None, train_dict: int = 0,
                 dict_size: int = 64 * 1024, checksum: bool = False):
        self._path = os.fspath(path)
        self._opts = opts if opts is not None else Options()
        self._offsets: list[int] = []
        self._dict: bytes | None = None
        self._dict_written = False
        self._train_target = max(int(train_dict), 0)
        self._dict_size = dict_size
        self._crc = bool(checksum)
        self._pending: list | None = [] if self._train_target else None
        if dictionary is not None or self._train_target:
            _zstandard()
        if append and os.path.exists(self._path):
            offsets, data_end, crc = _scan_or_index(self._path)
            self._crc = crc  # whole-stream property: adopt the file's flag
            self._offsets = offsets
            existing = _find_dict(self._path, data_end, crc)
            if existing is not None:
                self._dict = existing
                self._dict_written = True
                self._pending = None  # dict exists: no training pass
            self._f = open(self._path, "r+b")
            self._f.truncate(data_end)  # drop any footer
            self._f.seek(data_end)
        else:
            self._f = open(self._path, "wb")
            self._f.write(_pack_header(_FLAG_CRC if self._crc else 0))
        if dictionary is not None and self._dict is None:
            self._dict = bytes(dictionary)
            self._pending = None
        self._closed = False

    # -- writing ---------------------------------------------------------

    def _emit(self, frame: bytes) -> int:
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<Q", len(frame)))
        self._f.write(frame)
        if self._crc:
            import zlib

            self._f.write(struct.pack("<I", zlib.crc32(frame)))
        return len(self._offsets) - 1

    def _emit_dict_def(self) -> None:
        if self._dict is None or self._dict_written:
            return
        blob = DICT_MAGIC + bytes([_DICT_DEF]) + self._dict
        # a definition record: length-prefixed like data records but NOT
        # added to the logical index
        self._f.write(struct.pack("<Q", len(blob)))
        self._f.write(blob)
        if self._crc:
            import zlib

            self._f.write(struct.pack("<I", zlib.crc32(blob)))
        self._dict_written = True

    def _dict_record(self, raw: bytes, opts: Options) -> bytes:
        zstd = _zstandard()

        comp = zstd.ZstdCompressor(
            level=opts.clamped().level,
            dict_data=zstd.ZstdCompressionDict(self._dict),
        ).compress(raw)
        return (
            DICT_MAGIC + bytes([_DICT_PAYLOAD])
            + struct.pack("<Q", len(raw)) + comp
        )

    def _flush_pending(self) -> None:
        """Train (if possible) and write out the buffered records."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        samples = [raw for kind, raw, _ in pending if kind == "data"]
        if self._dict is None and len(samples) >= 7:
            try:
                self._dict = _zstandard().train_dictionary(
                    self._dict_size, samples
                ).as_bytes()
            except Exception:
                self._dict = None  # not enough/too-uniform data: plain frames
        self._emit_dict_def()
        from .api import compress_with_options

        for kind, payload, opts in pending:
            if kind == "frame":
                self._emit(payload)
            elif self._dict is not None:
                self._emit(self._dict_record(payload, opts))
            else:
                self._emit(compress_with_options(payload, opts))

    def write_frame(self, frame: bytes) -> int:
        """Append an already-compressed frame; returns its record index."""
        if self._closed:
            raise ValueError("stream writer is closed")
        if self._pending is not None:
            self._pending.append(("frame", bytes(frame), None))
            return self._logical_count() - 1
        return self._emit(frame)

    def write(self, data, opts: Options | None = None) -> int:
        """Compress host bytes/ndarray and append; returns record index."""
        opts = opts if opts is not None else self._opts
        raw = bytes(data) if isinstance(data, (bytes, bytearray, memoryview)) \
            else data.tobytes()
        if self._pending is not None:
            self._pending.append(("data", raw, opts))
            if len(self._pending) >= self._train_target:
                self._flush_pending()
            return self._logical_count() - 1
        if self._dict is not None:
            self._emit_dict_def()
            return self._emit(self._dict_record(raw, opts))
        from .api import compress_with_options

        return self._emit(compress_with_options(raw, opts))

    def write_many(self, items, opts: Options | None = None) -> list[int]:
        """Compress many records in one native batch; append in order.

        Record bytes are identical to calling write() per item (the batch
        compressor is byte-equal to the scalar path), but the frames are
        produced through one binding crossing with small frames scheduled
        across the core pool — the fast path for many-small-record
        streams.  Training/dictionary-mode streams keep the per-record
        path (dict records are zstd-dict streams, not Blosc frames).
        """
        if self._closed:
            raise ValueError("stream writer is closed")
        opts = opts if opts is not None else self._opts
        if self._pending is not None or self._dict is not None:
            return [self.write(d, opts) for d in items]
        from .api import compress_batch_with_options

        frames = compress_batch_with_options(items, opts)
        return [self._emit(f) for f in frames]

    def write_array(self, x, opts: Options | None = None,
                    strategy: str = "transfer") -> int:
        """Compress a (device) array via compress_array and append."""
        from .device import compress_array

        return self.write_frame(
            compress_array(x, opts if opts is not None else self._opts,
                           strategy=strategy)
        )

    def _logical_count(self) -> int:
        return len(self._offsets) + (
            len(self._pending) if self._pending is not None else 0
        )

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._flush_pending()
        n = len(self._offsets)
        index = struct.pack("<Q", n) + struct.pack(f"<{n}Q", *self._offsets)
        index += struct.pack("<Q", len(index) + 12) + FOOTER_MAGIC
        self._f.write(index)
        self._f.close()
        self._closed = True

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return self._logical_count()


def _find_dict(path: str, data_end: int, crc: bool = False) -> bytes | None:
    """Scan the data region for the stream's dictionary definition record.

    When the stream carries checksums, the definition record's crc32 is
    verified here — it is excluded from the logical index, so this is the
    only place a corrupted dictionary can be caught before every
    dict-compressed record silently decodes to wrong plaintext."""
    extra = 4 if crc else 0
    with open(path, "rb") as f:
        pos = HEADER_SIZE
        while pos + 8 <= data_end:
            f.seek(pos)
            (flen,) = struct.unpack("<Q", f.read(8))
            if flen < 5 or pos + 8 + flen + extra > data_end:
                return None
            peek = f.read(5)
            if peek[:4] == DICT_MAGIC and peek[4] == _DICT_DEF:
                f.seek(pos + 8)
                blob = f.read(flen)
                if crc:
                    import zlib

                    (want,) = struct.unpack("<I", f.read(4))
                    if zlib.crc32(blob) != want:
                        raise InvalidDataError(
                            "blosc: invalid compressed data: dictionary "
                            "record checksum mismatch"
                        )
                return blob[5:]
            pos += 8 + flen + extra
    return None


def _scan_or_index(path: str) -> tuple[list[int], int, bool]:
    """Record offsets, end-of-data position, and the crc flag — via the
    footer when intact, else a full scan."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
        if len(head) < HEADER_SIZE or head[:4] != MAGIC:
            raise InvalidHeaderError(
                "blosc: invalid header: not a TPBS stream file"
            )
        if head[4] != STREAM_VERSION:
            raise InvalidHeaderError(
                f"blosc: invalid version: stream version {head[4]}"
            )
        crc = bool(head[5] & _FLAG_CRC)
        extra = 4 if crc else 0
        # try the footer first
        if size >= HEADER_SIZE + 12:
            f.seek(size - 12)
            tail = f.read(12)
            if tail[8:] == FOOTER_MAGIC:
                (index_size,) = struct.unpack("<Q", tail[:8])
                index_start = size - index_size
                if HEADER_SIZE <= index_start < size:
                    f.seek(index_start)
                    blob = f.read(index_size - 12)
                    if len(blob) >= 8:
                        (n,) = struct.unpack_from("<Q", blob, 0)
                        if len(blob) == 8 + 8 * n:
                            offsets = list(
                                struct.unpack_from(f"<{n}Q", blob, 8)
                            )
                            if all(
                                HEADER_SIZE <= o < index_start
                                for o in offsets
                            ) and offsets == sorted(offsets):
                                return offsets, index_start, crc
        # sequential scan fallback (crashed writer / stripped footer)
        offsets = []
        pos = HEADER_SIZE
        while pos + 8 <= size:
            f.seek(pos)
            (flen,) = struct.unpack("<Q", f.read(8))
            if flen < 5 or pos + 8 + flen + extra > size:
                break  # trailing garbage (partial record or stale footer)
            # a record must start like something the stream can decode
            peek = f.read(5)
            if peek[:4] == DICT_MAGIC:
                if peek[4] == _DICT_DEF:
                    pos += 8 + flen + extra  # definition: not a logical record
                    continue
                if peek[4] != _DICT_PAYLOAD:
                    break
            elif not (
                (peek[:1] == b"\x02" and flen >= 16) or peek[:4] == b"TPB2"
            ):
                break
            offsets.append(pos)
            pos += 8 + flen + extra
        return offsets, pos, crc


class StreamReader:
    """Random + sequential access to a stream file's records."""

    def __init__(self, path):
        self._path = os.fspath(path)
        self._offsets, self._data_end, self._crc = _scan_or_index(self._path)
        self._f = open(self._path, "rb")
        self._lock = threading.Lock()  # iter_arrays prefetches on a thread
        self._dict: bytes | None = None
        self._dict_loaded = False
        self._closed = False

    def _get_dict(self) -> bytes:
        if not self._dict_loaded:
            self._dict = _find_dict(self._path, self._data_end, self._crc)
            self._dict_loaded = True
        if self._dict is None:
            raise InvalidDataError(
                "blosc: invalid compressed data: dictionary record missing"
            )
        return self._dict

    def _decode_dict_record(self, frame: bytes) -> bytes:
        zstd = _zstandard()

        if len(frame) < 13 or frame[4] != _DICT_PAYLOAD:
            raise InvalidDataError(
                "blosc: invalid compressed data: malformed dictionary record"
            )
        (orig,) = struct.unpack_from("<Q", frame, 5)
        # our writer embeds the content size in the zstd frame; cross-check
        # BEFORE allocating so a forged orig can't demand a huge buffer
        try:
            known = zstd.frame_content_size(frame[13:])
        except zstd.ZstdError as exc:
            raise DecompressionFailedError(f"zstd: {exc}") from exc
        if known != orig:
            raise InvalidDataError(
                "blosc: invalid compressed data: dictionary record size "
                f"field {orig} disagrees with zstd frame header {known}"
            )
        try:
            out = zstd.ZstdDecompressor(
                dict_data=zstd.ZstdCompressionDict(self._get_dict())
            ).decompress(frame[13:], max_output_size=max(orig, 1))
        except zstd.ZstdError as exc:
            raise DecompressionFailedError(f"zstd: {exc}") from exc
        if len(out) != orig:
            raise SizeMismatchError(
                f"blosc: decompressed size mismatch: got {len(out)}, "
                f"expected {orig}"
            )
        return out

    def __len__(self) -> int:
        return len(self._offsets)

    def read_frame(self, i: int) -> bytes:
        """The i-th record's raw compressed frame bytes."""
        if not 0 <= i < len(self._offsets):
            raise IndexError(f"record {i} out of range ({len(self._offsets)})")
        off = self._offsets[i]
        if off + 8 > self._data_end:
            raise InvalidDataError(
                f"blosc: invalid compressed data: record {i} offset out of range"
            )
        extra = 4 if self._crc else 0
        with self._lock:
            self._f.seek(off)
            (flen,) = struct.unpack("<Q", self._f.read(8))
            # bound BEFORE allocating: a corrupt length field must not
            # turn into a multi-GB read (found by the corruption fuzz)
            if flen + extra > self._data_end - off - 8:
                raise InvalidDataError(
                    f"blosc: invalid compressed data: record {i} "
                    "length overruns file"
                )
            frame = self._f.read(flen)
            tail = self._f.read(extra)
        if len(frame) != flen or len(tail) != extra:
            raise InvalidDataError(
                f"blosc: invalid compressed data: truncated record {i}"
            )
        if self._crc:
            import zlib

            (want,) = struct.unpack("<I", tail)
            if zlib.crc32(frame) != want:
                raise InvalidDataError(
                    f"blosc: invalid compressed data: record {i} "
                    "checksum mismatch"
                )
        return frame

    def read(self, i: int) -> bytes:
        """Decompress the i-th record to bytes."""
        frame = self.read_frame(i)
        if frame[:4] == DICT_MAGIC:
            return self._decode_dict_record(frame)
        from .api import decompress

        return decompress(frame)

    def read_many(self, indices=None) -> list[bytes]:
        """Decompress several records (default: all) in one native batch.

        Results match ``[self.read(i) for i in indices]`` exactly; plain
        Blosc-frame records decode through api.decompress_batch (one
        binding crossing, whole small frames across the core pool),
        dictionary records through their zstd-dict path per record.
        """
        if indices is None:
            indices = range(len(self._offsets))
        frames = [self.read_frame(i) for i in indices]
        out: list = [None] * len(frames)
        plain = [k for k, f in enumerate(frames) if f[:4] != DICT_MAGIC]
        if plain:
            from .api import decompress_batch

            for k, data in zip(plain, decompress_batch([frames[k] for k in plain])):
                out[k] = data
        for k, f in enumerate(frames):
            if out[k] is None:
                out[k] = self._decode_dict_record(f)
        return out

    def peek_size(self, i: int) -> int:
        """Declared decompressed size of record i from its header prefix.

        Reads ~28 bytes: plain frames report NBytesOrig, TPB2 containers
        their u64 total, dictionary records their u64 original size.  The
        value is the producer's declaration — decoding still validates it
        — so callers may use it to size buffers without trusting it as
        ground truth (read_many_into re-checks on decode).
        """
        if not 0 <= i < len(self._offsets):
            raise IndexError(f"record {i} out of range ({len(self._offsets)})")
        off = self._offsets[i]
        with self._lock:
            self._f.seek(off)
            hdr = self._f.read(8 + 20)
        if len(hdr) < 8 + 16:
            raise InvalidDataError(
                f"blosc: invalid compressed data: truncated record {i}"
            )
        (flen,) = struct.unpack_from("<Q", hdr, 0)
        prefix = hdr[8 : 8 + min(20, flen)]
        if prefix[:4] == DICT_MAGIC:
            if len(prefix) >= 13 and prefix[4] == _DICT_PAYLOAD:
                return struct.unpack_from("<Q", prefix, 5)[0]
        elif prefix[:4] == b"TPB2":
            if len(prefix) >= 16:
                return struct.unpack_from("<Q", prefix, 8)[0]
        elif len(prefix) >= 16 and prefix[0] == 2:
            return struct.unpack_from("<I", prefix, 4)[0]
        raise InvalidDataError(
            f"blosc: invalid compressed data: record {i} has no "
            "recognizable header"
        )

    def read_many_into(self, indices, outs) -> list[int]:
        """Batch-decode records straight into caller buffers (zero-copy).

        ``outs[k]`` receives record ``indices[k]``; returns bytes written
        per record.  Plain frames go through api.decompress_batch_into;
        dictionary records decode and copy (their zstd path has no
        in-place decode).
        """
        indices = list(indices)
        outs = list(outs)
        if len(indices) != len(outs):
            raise ValueError("outs length must match indices length")
        frames = [self.read_frame(i) for i in indices]
        plain = [k for k, f in enumerate(frames) if f[:4] != DICT_MAGIC]
        counts: list = [None] * len(frames)
        if plain:
            from .api import decompress_batch_into

            for k, c in zip(
                plain,
                decompress_batch_into(
                    [frames[k] for k in plain], [outs[k] for k in plain]
                ),
            ):
                counts[k] = c
        for k, f in enumerate(frames):
            if counts[k] is None:
                import numpy as np

                from .api import _writable_u8_view

                buf = self._decode_dict_record(f)
                view = _writable_u8_view(outs[k])
                if view.size < len(buf):
                    raise InvalidDataError(
                        f"blosc: output buffer too small: need {len(buf)}, "
                        f"have {view.size}"
                    )
                view[: len(buf)] = np.frombuffer(buf, dtype=np.uint8)
                counts[k] = len(buf)
        return counts

    def read_range(self, i: int, start: int, size: int) -> bytes:
        """Bytes [start, start+size) of record i — multi-block records
        decode only the covering blocks (api.decompress_range)."""
        frame = self.read_frame(i)
        if frame[:4] == DICT_MAGIC:
            # same bounds contract as decompress_range: out-of-range must
            # raise, never silently truncate
            buf = self._decode_dict_record(frame)
            if start < 0 or size < 0:
                raise InvalidDataError(
                    "blosc: invalid compressed data: negative range"
                )
            if start + size > len(buf):
                raise SizeMismatchError(
                    f"blosc: decompressed size mismatch: range "
                    f"[{start}, {start + size}) outside {len(buf)} bytes"
                )
            return buf[start : start + size]
        from .api import decompress_range

        return decompress_range(frame, start, size)

    def read_array(self, i: int, dtype, shape=None, sharding=None,
                   strategy: str = "auto"):
        """Decompress the i-th record straight onto a device.

        ``strategy`` forwards to :func:`tpu_blosc.device.decompress_array`
        ("records"/"rle" ship O(literal) records over the link, "device"
        unfilters on device); dictionary records always host-decode."""
        frame = self.read_frame(i)
        if frame[:4] == DICT_MAGIC:
            import jax
            import numpy as np

            buf = self._decode_dict_record(frame)
            arr = np.frombuffer(buf, dtype=dtype)
            if shape is not None:
                arr = arr.reshape(shape)
            if sharding is not None:
                return jax.device_put(arr, sharding)
            return jax.device_put(arr)
        from .device import decompress_array

        return decompress_array(frame, dtype, shape=shape, sharding=sharding,
                                strategy=strategy)

    def iter_arrays(self, dtype, shape=None, sharding=None,
                    prefetch: int = 2):
        """Iterate records as device arrays with background prefetch.

        The data-loader hot path: while step k computes, record k+1 is
        decoded on the host and staged to the device by a worker thread
        (decode + transfer overlap compute).  ``prefetch`` bounds the
        number of in-flight arrays (device memory = prefetch x record).
        """
        return _ArrayIterator(self, dtype, shape, sharding, prefetch)

    def verify(self, deep: bool = False) -> int:
        """Integrity sweep: walk every record, checking lengths and (when
        the stream carries them) per-record crc32s; ``deep=True`` also
        decompresses each record and discards the result.  Returns the
        number of records verified; raises BloscError at the first bad
        one.  The restore-path preflight for checkpoint files."""
        # the dictionary definition record is excluded from the logical
        # index; _find_dict crc-checks it for checksummed streams
        _find_dict(self._path, self._data_end, self._crc)
        if not deep:
            for i in range(len(self)):
                self.read_frame(i)
            return len(self)
        # deep: batch-decode in windows bounded by declared size (memory
        # stays ~window-sized on huge checkpoints); read_many walks its
        # frames in order, so the first bad record raises the same typed
        # error the serial loop would
        n_rec = len(self)
        i = 0
        while i < n_rec:
            j, budget = i + 1, 0
            while j < n_rec and budget < (64 << 20):
                try:
                    budget += self.peek_size(j)
                except BloscError:
                    break  # malformed header: let read_many raise canonically
                j += 1
            self.read_many(range(i, j))
            i = j
        return n_rec

    def sizes(self) -> list[tuple[int, int]]:
        """(compressed, uncompressed) byte sizes per record."""
        from .api import get_decompressed_size

        out = []
        for i in range(len(self)):
            frame = self.read_frame(i)
            if frame[:4] == DICT_MAGIC:
                (orig,) = struct.unpack_from("<Q", frame, 5)
                out.append((len(frame), orig))
            else:
                out.append((len(frame), get_decompressed_size(frame)))
        return out

    def __getitem__(self, i: int) -> bytes:
        return self.read(i)

    def __iter__(self):
        for i in range(len(self)):
            yield self.read(i)

    def close(self) -> None:
        if not self._closed:
            self._f.close()
            self._closed = True

    def __enter__(self) -> "StreamReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save(path, data, opts: Options | None = None) -> None:
    """Write one compressed record to ``path`` (single-chunk convenience)."""
    with StreamWriter(path, opts) as w:
        w.write(data)


def load(path, i: int = 0) -> bytes:
    """Read one record from ``path`` (single-chunk convenience)."""
    with StreamReader(path) as r:
        return r.read(i)


def save_array(path, x, opts: Options | None = None,
               strategy: str = "transfer") -> None:
    """Compress a (device) array to ``path`` via the device filter path."""
    with StreamWriter(path, opts) as w:
        w.write_array(x, strategy=strategy)


def load_array(path, dtype, shape=None, sharding=None, i: int = 0):
    """Read one record from ``path`` straight onto a device."""
    with StreamReader(path) as r:
        return r.read_array(i, dtype, shape=shape, sharding=sharding)


def _iter_prefetch(make_item, n: int, prefetch: int):
    """Run make_item(i) a few steps ahead on a worker thread."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def put_checked(entry) -> bool:
        # never block forever: if the consumer abandoned iteration while
        # the queue is full, a plain q.put would pin this thread (and the
        # prefetched device arrays it holds) for the process lifetime
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        for i in range(n):
            if stop.is_set():
                return
            try:
                entry = (i, make_item(i), None)
            except Exception as exc:  # propagate to the consumer
                put_checked((i, None, exc))
                return
            if not put_checked(entry):
                return
        put_checked((None, None, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            i, item, exc = q.get()
            if exc is not None:
                raise exc
            if i is None:
                return
            yield item
    finally:
        stop.set()


class _ArrayIterator:
    """Iterable over a stream's records as device arrays with prefetch."""

    def __init__(self, reader: "StreamReader", dtype, shape, sharding,
                 prefetch: int):
        self._r = reader
        self._dtype = dtype
        self._shape = shape
        self._sharding = sharding
        self._prefetch = prefetch

    def __len__(self) -> int:
        return len(self._r)

    def __iter__(self):
        return _iter_prefetch(
            lambda i: self._r.read_array(
                i, self._dtype, shape=self._shape, sharding=self._sharding
            ),
            len(self._r),
            self._prefetch,
        )
