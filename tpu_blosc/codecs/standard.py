"""The five standard codecs, registered at import (≙ codec.go:27-33).

Level-mapping parity with the reference:
  LZ4    — level ignored (codec.go:63-75)
  LZ4HC  — 1-3 / 4-5 / 6-7 / 8-9 effort tiers (codec.go:96-106)
  ZLIB   — passthrough 1-9 (codec.go:138-152)
  ZSTD   — 1-2 fastest / 3-4 default / 5-6 better / 7-9 best (codec.go:200-213)
  Snappy — no levels (codec.go:232-235)

LZ4/LZ4HC/Snappy streams come from our own from-scratch implementations
(this environment has no lz4/snappy modules); each transparently uses the
C++ native backend (native/tpublosc.cpp via ctypes) when available and the
pure-Python reference otherwise — the same boolean-fallback contract the
reference uses for its SIMD kernels (shuffle.go:31-57).
"""

from __future__ import annotations

import zlib as _zlib

from ..errors import CompressionFailedError, DecompressionFailedError
from ..format import Codec
from . import blosclz_ref, lz4_ref, snappy_ref
from .registry import register_codec

try:
    import zstandard as _zstd
except ImportError:  # the native runtime's libzstd serves ZSTD instead
    _zstd = None

try:
    from ..native import backend as _native
except Exception:  # pragma: no cover - native build failure → pure Python
    _native = None


def _native_ok() -> bool:
    return _native is not None and _native.available()


class BloscLzCodec:
    """BloscLZ (codec ID 0) — our extension; the reference declares the enum
    but never implements it (blosc.go:58, "internal, not implemented").
    Format spec + oracle: blosclz_ref.py.  Level ignored, like LZ4."""

    def name(self) -> str:
        return "blosclz"

    def compress(self, data: bytes, level: int) -> bytes:
        if _native_ok():
            return _native.blosclz_compress(data)
        return blosclz_ref.compress(data)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        if _native_ok():
            return _native.blosclz_decompress(data, expected_size)
        return blosclz_ref.decompress(data, expected_size)


class Lz4Codec:
    """LZ4 block codec; level ignored (≙ lz4Codec, codec.go:59-84)."""

    def name(self) -> str:
        return "lz4"

    def compress(self, data: bytes, level: int) -> bytes:
        if _native_ok():
            return _native.lz4_compress(data, depth=1)
        return lz4_ref.compress_block(data, max_search_depth=1)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        if _native_ok():
            return _native.lz4_decompress(data, expected_size)
        return lz4_ref.decompress_block(data, expected_size)


class Lz4HcCodec:
    """LZ4 high-compression: deeper match search (≙ lz4hcCodec, codec.go:90-128)."""

    def name(self) -> str:
        return "lz4hc"

    def compress(self, data: bytes, level: int) -> bytes:
        depth = lz4_ref.hc_depth_for_level(level)
        if _native_ok():
            return _native.lz4_compress(data, depth=depth)
        return lz4_ref.compress_block(data, max_search_depth=depth)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        # decompression is the same as standard LZ4 (codec.go:120-128)
        if _native_ok():
            return _native.lz4_decompress(data, expected_size)
        return lz4_ref.decompress_block(data, expected_size)


class SnappyCodec:
    """Raw Snappy; no levels (≙ snappyCodec, codec.go:228-244)."""

    def name(self) -> str:
        return "snappy"

    def compress(self, data: bytes, level: int) -> bytes:
        if _native_ok():
            return _native.snappy_compress(data)
        return snappy_ref.compress(data)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        if _native_ok():
            return _native.snappy_decompress(data, expected_size)
        return snappy_ref.decompress(data, expected_size)


class ZlibCodec:
    """ZLIB/deflate via CPython zlib; levels pass through (≙ zlibCodec)."""

    def name(self) -> str:
        return "zlib"

    def compress(self, data: bytes, level: int) -> bytes:
        if not 1 <= level <= 9:
            # parity with kzlib.NewWriterLevel rejecting invalid levels
            # (exercised by reference codec_test.go:298-318)
            raise CompressionFailedError(f"zlib: invalid compression level {level}")
        return _zlib.compress(bytes(data), level)

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        try:
            return _zlib.decompress(bytes(data))
        except _zlib.error as exc:
            raise DecompressionFailedError(f"zlib: {exc}") from exc


class ZstdCodec:
    """Zstandard with persistent per-tier compressors (≙ zstdCodec, codec.go:173-222).

    The reference keeps 4 shared encoders (SpeedFastest/Default/Better/Best)
    and one shared decoder; we mirror that with zstd levels 1/3/9/19 (the
    zstd-library levels those Go speed tiers correspond to).  Streams come
    from python-zstandard when it is installed, else from the libzstd the
    native runtime loads (``native.backend.zstd_available``).
    """

    _TIER_LEVELS = (1, 3, 9, 19)

    def __init__(self) -> None:
        if _zstd is None:
            if not (_native_ok() and _native.zstd_available()):
                raise RuntimeError(
                    "zstd needs the zstandard module or the native runtime "
                    "with a loadable libzstd"
                )
            self._encoders = None
            return
        self._encoders = [
            _zstd.ZstdCompressor(level=lv) for lv in self._TIER_LEVELS
        ]
        # one decompressor per thread: python-zstandard instances share a
        # single DCtx and stream_reader corrupts under concurrent use —
        # thread-locals keep the reference's concurrent-decoder contract
        # (codec.go:177-198) without a lock on the decode path
        import threading

        self._local = threading.local()

    def _decoder(self) -> "_zstd.ZstdDecompressor":
        d = getattr(self._local, "d", None)
        if d is None:
            d = _zstd.ZstdDecompressor()
            self._local.d = d
        return d

    def name(self) -> str:
        return "zstd"

    @staticmethod
    def _tier(level: int) -> int:
        if level <= 2:
            return 0
        if level <= 4:
            return 1
        if level <= 6:
            return 2
        return 3

    def compress(self, data: bytes, level: int) -> bytes:
        if self._encoders is None:
            return _native.zstd_compress(
                data, self._TIER_LEVELS[self._tier(level)]
            )
        return self._encoders[self._tier(level)].compress(bytes(data))

    def decompress(self, data: bytes, expected_size: int) -> bytes:
        # Read across frames unconditionally: payloads may hold several
        # concatenated frames (RFC 8878 §3 — klauspost DecodeAll and the
        # native decoder both read them) and plain decompress() stops at
        # the first boundary.  Reading expected_size+1 bounds memory on
        # forged headers AND makes a trailing non-empty frame overflow
        # into a size mismatch — the same accept/reject the native path
        # gives (a first frame of exactly expected_size followed by more
        # content must not silently pass).
        if self._encoders is None:
            return _native.zstd_decompress(data, expected_size)
        import io

        try:
            return self._decoder().stream_reader(
                io.BytesIO(bytes(data)), read_across_frames=True
            ).read(expected_size + 1)
        except _zstd.ZstdError as exc:
            raise DecompressionFailedError(f"zstd: {exc}") from exc


# The instances installed by register_standard_codecs; native fast paths
# apply only while the registry still maps an ID to its builtin instance
# (a user's register_codec override must win, ≙ RegisterCodec semantics).
_BUILTIN_INSTANCES: dict[int, object] = {}


def register_standard_codecs() -> None:
    pairs = [
        (Codec.BLOSCLZ, BloscLzCodec()),
        (Codec.LZ4, Lz4Codec()),
        (Codec.LZ4HC, Lz4HcCodec()),
        (Codec.SNAPPY, SnappyCodec()),
        (Codec.ZLIB, ZlibCodec()),
    ]
    if _zstd is not None or (_native_ok() and _native.zstd_available()):
        pairs.append((Codec.ZSTD, ZstdCodec()))
    for cid, impl in pairs:
        _BUILTIN_INSTANCES[int(cid)] = impl
        register_codec(cid, impl)


def is_builtin(codec_id: int) -> bool:
    """True when the registry entry for this ID is the builtin instance."""
    from .registry import get_codec

    return get_codec(codec_id) is _BUILTIN_INSTANCES.get(int(codec_id))


register_standard_codecs()
