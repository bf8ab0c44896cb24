"""tpu_blosc — a Blosc compression framework for accelerator-resident data.

A from-scratch JAX/XLA re-design of the Blosc compressed-frame
format with the full capability surface of the reference Go library
(github.com/mrjoshuak/go-blosc): 16-byte frame header, byte-shuffle and
bit-shuffle filters, five codecs (LZ4, LZ4HC, ZSTD, ZLIB, Snappy), an open
codec registry, memcpy fallback, and introspection — plus device
extensions: on-device shuffle filters for jax.Arrays, multi-block chunked
frames, and data-parallel block sharding across device meshes.

Basic usage (mirrors reference blosc.go:8-20):

    import tpu_blosc as blosc

    compressed = blosc.compress(data, blosc.Codec.LZ4, 5, blosc.Shuffle.SHUFFLE, 4)
    decompressed = blosc.decompress(compressed)

All functions are safe for concurrent use (reference parity, blosc.go:37-39).
"""

from .api import (
    AUTO_BLOCK_THRESHOLD,
    compress,
    compress_batch,
    compress_batch_with_options,
    compress_with_options,
    decompress,
    decompress_batch,
    decompress_batch_into,
    decompress_into,
    decompress_range,
    decompress_range_into,
    decompress_with_size,
    get_decompressed_size,
    get_info,
    suggest_codec,
    suggest_options,
)
from .codecs.registry import get_codec, list_codecs, register_codec
from .errors import (
    BloscError,
    CompressionFailedError,
    DataTooLargeError,
    DecompressionFailedError,
    InvalidCodecError,
    InvalidDataError,
    InvalidHeaderError,
    InvalidVersionError,
    SizeMismatchError,
)
from .filters import (
    backend_name,
    bit_shuffle,
    bit_unshuffle,
    shuffle_buffer,
    shuffle_bytes,
    unshuffle_buffer,
    unshuffle_bytes,
)
from .format import (
    FLAG_BITSHUFFLE,
    FLAG_MEMCPY,
    FLAG_SHUFFLE,
    FLAG_SPLIT,
    FORMAT_VERSION,
    HEADER_SIZE,
    MIN_HEADER_SIZE,
    VERSION,
    Codec,
    Header,
    Shuffle,
    parse_header,
)
from .array import pack_array, unpack_array, unpack_array_rows
from .device import compress_array, decompress_array
from .options import Options, default_options
from .stats import CompressionStats, FrameStats, compress_with_stats, frame_stats
from .checkpoint import load_pytree, save_pytree
from .stream import (
    StreamReader,
    StreamWriter,
    load,
    load_array,
    save,
    save_array,
)

# Convenience aliases matching the reference's enum spelling
BLOSCLZ = Codec.BLOSCLZ
LZ4 = Codec.LZ4
LZ4HC = Codec.LZ4HC
SNAPPY = Codec.SNAPPY
ZLIB = Codec.ZLIB
ZSTD = Codec.ZSTD
NOSHUFFLE = Shuffle.NOSHUFFLE
SHUFFLE = Shuffle.SHUFFLE
BITSHUFFLE = Shuffle.BITSHUFFLE

__version__ = VERSION

__all__ = [
    "AUTO_BLOCK_THRESHOLD",
    "BITSHUFFLE",
    "BLOSCLZ",
    "BloscError",
    "Codec",
    "CompressionFailedError",
    "DataTooLargeError",
    "DecompressionFailedError",
    "FLAG_BITSHUFFLE",
    "FLAG_MEMCPY",
    "FLAG_SHUFFLE",
    "FLAG_SPLIT",
    "FORMAT_VERSION",
    "HEADER_SIZE",
    "Header",
    "InvalidCodecError",
    "InvalidDataError",
    "InvalidHeaderError",
    "InvalidVersionError",
    "LZ4",
    "LZ4HC",
    "MIN_HEADER_SIZE",
    "NOSHUFFLE",
    "Options",
    "SHUFFLE",
    "SNAPPY",
    "Shuffle",
    "StreamReader",
    "StreamWriter",
    "SizeMismatchError",
    "VERSION",
    "ZLIB",
    "ZSTD",
    "backend_name",
    "bit_shuffle",
    "bit_unshuffle",
    "compress",
    "compress_array",
    "compress_batch",
    "compress_batch_with_options",
    "compress_with_options",
    "compress_with_stats",
    "CompressionStats",
    "FrameStats",
    "frame_stats",
    "decompress",
    "decompress_array",
    "decompress_batch",
    "decompress_batch_into",
    "decompress_into",
    "decompress_range",
    "decompress_range_into",
    "decompress_with_size",
    "default_options",
    "get_codec",
    "get_decompressed_size",
    "load",
    "load_array",
    "load_pytree",
    "get_info",
    "list_codecs",
    "parse_header",
    "register_codec",
    "save",
    "save_array",
    "save_pytree",
    "shuffle_buffer",
    "suggest_codec",
    "suggest_options",
    "shuffle_bytes",
    "unshuffle_buffer",
    "unshuffle_bytes",
]
