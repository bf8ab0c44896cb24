"""Codec-layer tests (≙ reference codec_test.go): LZ4/Snappy stream validity,
level mappings, registry, and cross-validation of independent implementations.
"""

import zlib as pyzlib

import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc.codecs import lz4_ref, snappy_ref
from tpu_blosc.codecs.registry import get_codec

rng = np.random.default_rng(7)


CORPUS = [
    b"",
    b"a",
    b"aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    b"abcabcabcabcabcabcabcabcabcabcabc",
    bytes(range(256)) * 8,
    rng.integers(0, 256, 10000, dtype=np.uint8).tobytes(),  # incompressible
    np.arange(4096, dtype=np.float32).tobytes(),
    b"\x00" * 5000,
    (b"the quick brown fox jumps over the lazy dog. " * 100),
    rng.integers(0, 4, 8192, dtype=np.uint8).tobytes(),  # low entropy
]


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_lz4_roundtrip(i):
    data = CORPUS[i]
    comp = lz4_ref.compress_block(data)
    assert lz4_ref.decompress_block(comp, len(data)) == data


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_lz4_hc_roundtrip_and_ratio(i):
    data = CORPUS[i]
    fast = lz4_ref.compress_block(data, max_search_depth=1)
    hc = lz4_ref.compress_block(data, max_search_depth=64)
    assert lz4_ref.decompress_block(hc, len(data)) == data
    # HC never loses to fast by much; usually wins
    assert len(hc) <= len(fast) + 8


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_snappy_roundtrip(i):
    data = CORPUS[i]
    comp = snappy_ref.compress(data)
    assert snappy_ref.decompress(comp, len(data)) == data


def test_lz4_known_vector_literals_only():
    # A short input is a single literal run: token = len<<4, then bytes
    data = b"hello"
    comp = lz4_ref.compress_block(data)
    assert comp == bytes([5 << 4]) + data


def test_lz4_decoder_rejects_malformed():
    with pytest.raises(blosc.DecompressionFailedError):
        lz4_ref.decompress_block(b"\xf0", 100)  # truncated literal extension
    with pytest.raises(blosc.DecompressionFailedError):
        lz4_ref.decompress_block(bytes([1 << 4]) + b"a" + b"\x00\x00", 100)  # offset 0
    with pytest.raises(blosc.DecompressionFailedError):
        # match offset beyond output written so far
        lz4_ref.decompress_block(bytes([(1 << 4) | 0]) + b"a" + b"\xff\x00", 100)


def test_snappy_decoder_rejects_malformed():
    with pytest.raises(blosc.DecompressionFailedError):
        snappy_ref.decompress(b"", 0)
    with pytest.raises(blosc.DecompressionFailedError):
        # preamble says 10 bytes but stream holds none
        snappy_ref.decompress(b"\x0a", 10)


def test_snappy_long_literals_and_copies():
    # literal length > 60 exercises extended length encoding; long runs
    # exercise copy splitting
    data = rng.integers(0, 256, 200, dtype=np.uint8).tobytes() + b"\x07" * 1000
    comp = snappy_ref.compress(data)
    assert snappy_ref.decompress(comp, len(data)) == data


def test_zlib_stream_is_standard():
    # our zlib codec must produce streams the CPython zlib reads and vice versa
    codec = get_codec(blosc.Codec.ZLIB)
    data = b"standard zlib stream" * 50
    assert pyzlib.decompress(codec.compress(data, 6)) == data
    assert codec.decompress(pyzlib.compress(data, 6), len(data)) == data


def test_zstd_stream_is_standard():
    import zstandard

    codec = get_codec(blosc.Codec.ZSTD)
    data = b"standard zstd stream" * 50
    assert zstandard.ZstdDecompressor().decompress(
        codec.compress(data, 5), max_output_size=len(data)
    ) == data
    assert (
        codec.decompress(zstandard.ZstdCompressor(level=3).compress(data), len(data))
        == data
    )


def test_zlib_invalid_level_errors():
    # ≙ codec_test.go:298-318 — invalid zlib levels error out
    codec = get_codec(blosc.Codec.ZLIB)
    with pytest.raises(blosc.CompressionFailedError):
        codec.compress(b"data", 0)
    with pytest.raises(blosc.CompressionFailedError):
        codec.compress(b"data", 10)


def test_lz4hc_level_mapping_tiers():
    # ≙ codec.go:96-106 tier boundaries via hc_depth_for_level
    d = lz4_ref.hc_depth_for_level
    assert d(1) == d(2) == d(3)
    assert d(4) == d(5)
    assert d(6) == d(7)
    assert d(8) == d(9)
    assert d(1) < d(4) < d(6) < d(8)


def test_zstd_level_mapping_tiers():
    from tpu_blosc.codecs.standard import ZstdCodec

    t = ZstdCodec._tier
    assert t(1) == t(2) == 0
    assert t(3) == t(4) == 1
    assert t(5) == t(6) == 2
    assert t(7) == t(8) == t(9) == 3


class MockCodec:
    """Identity codec (≙ mockCodecImpl, codec_test.go:472-487)."""

    def name(self):
        return "mock"

    def compress(self, data, level):
        return bytes(data)

    def decompress(self, data, expected_size):
        return bytes(data)


def test_register_custom_codec():
    # ≙ RegisterCodec tests (codec_test.go:81-100)
    mock_id = 42
    blosc.register_codec(mock_id, MockCodec())
    assert blosc.get_codec(mock_id) is not None
    assert mock_id in [int(c) for c in blosc.list_codecs()]
    got = blosc.get_codec(mock_id)
    assert got.compress(b"abc", 1) == b"abc"
    assert got.name() == "mock"


def test_list_codecs_contains_standard_five():
    ids = {int(c) for c in blosc.list_codecs()}
    for c in [blosc.LZ4, blosc.LZ4HC, blosc.SNAPPY, blosc.ZLIB, blosc.ZSTD]:
        assert int(c) in ids


def test_unregistered_codec_compress_error():
    # ID 7 is unassigned (BLOSCLZ=0 is implemented here — our extension;
    # the reference leaves the slot empty, blosc.go:58)
    with pytest.raises(blosc.InvalidCodecError):
        blosc.compress(b"data", 7, 5, blosc.NOSHUFFLE, 1)


def test_zstd_codec_served_by_native_without_zstandard(monkeypatch):
    """Without python-zstandard the ZSTD codec rides the libzstd that the
    native runtime loads: standard frames, every tier, both directions."""
    import zstandard

    from tpu_blosc.codecs import standard
    from tpu_blosc.native import backend as nb

    if not nb.zstd_available():
        pytest.skip("native runtime has no libzstd")
    monkeypatch.setattr(standard, "_zstd", None)
    codec = standard.ZstdCodec()
    data = np.arange(200_000, dtype=np.float32).tobytes()
    for level in (1, 3, 5, 9):
        comp = codec.compress(data, level)
        assert zstandard.ZstdDecompressor().decompress(comp) == data
        assert codec.decompress(comp, len(data)) == data
    other = zstandard.ZstdCompressor(level=3).compress(data)
    assert codec.decompress(other, len(data)) == data
    with pytest.raises(blosc.DecompressionFailedError):
        codec.decompress(other[:-9], len(data))


def test_zstd_stays_registered_without_zstandard(monkeypatch):
    from tpu_blosc.codecs import standard
    from tpu_blosc.native import backend as nb

    if not nb.zstd_available():
        pytest.skip("native runtime has no libzstd")
    monkeypatch.setattr(standard, "_zstd", None)
    try:
        standard.register_standard_codecs()
        assert standard.is_builtin(blosc.ZSTD)
        data = bytes(range(256)) * 4096
        for frame in (
            blosc.compress(data, blosc.ZSTD, 5, blosc.SHUFFLE, 4),
            blosc.compress_with_options(
                data, blosc.Options(codec=blosc.ZSTD, block_size=65536)
            ),
        ):
            assert blosc.decompress(frame) == data
    finally:
        monkeypatch.undo()
        standard.register_standard_codecs()
