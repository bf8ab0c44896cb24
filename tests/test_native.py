"""Native C++ backend tests: oracle parity, pipelines, malformed streams.

Mirrors the reference's SIMD-vs-oracle strategy (shuffle_amd64_test.go:152-174:
direct kernel calls checked against the generic implementation) — here the
"SIMD kernel" is libtpublosc.so and the oracle is filters/reference.py and
the pure-Python codecs.
"""

import os

import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc.codecs import lz4_ref, snappy_ref
from tpu_blosc.filters import reference as ref
from tpu_blosc.native import backend as nb

pytestmark = pytest.mark.skipif(
    not nb.available(), reason="native backend unavailable"
)

SIZES = [1, 2, 7, 13, 28, 35, 64, 100, 257, 1003, 4096, 65537, 1 << 20]
TYPE_SIZES = [1, 2, 3, 4, 5, 7, 8, 12, 16]


def _data(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "rand":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "ramp":
        return (np.arange(n) % 256).astype(np.uint8).tobytes()
    if kind == "period3":
        return (np.arange(n) % 3).astype(np.uint8).tobytes()
    return bytes(n)


# ---------------------------------------------------------------------------
# shuffle kernels vs oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ts", TYPE_SIZES)
def test_shuffle_matches_oracle(ts):
    for n in SIZES:
        d = _data(n, "rand", seed=ts)
        assert np.array_equal(nb.shuffle(d, ts), ref.shuffle_bytes(d, ts))
        assert np.array_equal(nb.unshuffle(d, ts), ref.unshuffle_bytes(d, ts))


@pytest.mark.parametrize("ts", TYPE_SIZES)
def test_bitshuffle_matches_oracle(ts):
    for n in SIZES:
        d = _data(n, "rand", seed=100 + ts)
        assert np.array_equal(nb.bitshuffle(d, ts), ref.bit_shuffle(d, ts))
        assert np.array_equal(
            nb.bitunshuffle(d, ts), ref.bit_unshuffle(d, ts)
        )


def test_shuffle_roundtrip_large():
    d = np.arange(1 << 22, dtype=np.float32).tobytes()  # 16 MiB, OMP path
    s = nb.shuffle(d, 4)
    assert np.array_equal(s, ref.shuffle_bytes(d, 4))
    assert nb.unshuffle(s, 4).tobytes() == d
    b = nb.bitshuffle(d, 4)
    assert np.array_equal(b, ref.bit_shuffle(d, 4))
    assert nb.bitunshuffle(b, 4).tobytes() == d


# ---------------------------------------------------------------------------
# codecs: cross-implementation parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rand", "ramp", "zeros", "period3"])
def test_lz4_cross_parity(kind):
    for n in [0, 1, 5, 12, 13, 100, 1000, 65536]:
        d = _data(n, kind)
        for depth in (1, 16):
            c = nb.lz4_compress(d, depth)
            assert nb.lz4_decompress(c, n) == d
            # native stream decodable by the pure-Python decoder
            assert lz4_ref.decompress_block(c, n) == d
        # pure-Python stream decodable by the native decoder
        assert nb.lz4_decompress(lz4_ref.compress_block(d), n) == d


@pytest.mark.parametrize("kind", ["rand", "ramp", "zeros", "period3"])
def test_snappy_cross_parity(kind):
    for n in [0, 1, 5, 15, 16, 100, 1000, 65536]:
        d = _data(n, kind)
        c = nb.snappy_compress(d)
        assert nb.snappy_decompress(c, n) == d
        assert snappy_ref.decompress(c, n) == d
        assert nb.snappy_decompress(snappy_ref.compress(d), n) == d


def test_lz4_hc_not_worse_much():
    d = _data(1 << 16, "ramp")
    fast = len(nb.lz4_compress(d, 1))
    hc = len(nb.lz4_compress(d, 64))
    assert hc <= fast  # deeper search never loses on this data


def test_lz4_malformed_streams_rejected():
    from tpu_blosc.errors import DecompressionFailedError

    good = nb.lz4_compress(b"hello world, hello world, hello world", 1)
    for bad in [
        good[:1],
        good[:-1],
        b"\xff" * 10,
        b"\x10",             # literal run of 1, no literal byte
        b"\x00\x01\x00",     # match with offset into nothing
    ]:
        with pytest.raises(DecompressionFailedError):
            nb.lz4_decompress(bad, 38)


def test_snappy_malformed_streams_rejected():
    from tpu_blosc.errors import DecompressionFailedError

    for bad in [b"", b"\xff" * 11, b"\x05\x00", b"\x04\x01\x00"]:
        with pytest.raises(DecompressionFailedError):
            nb.snappy_decompress(bad, 5)


# ---------------------------------------------------------------------------
# whole-chunk pipelines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle_mode", [0, 1, 2])
@pytest.mark.parametrize(
    "codec,depth",
    [(nb.NATIVE_LZ4, 1), (nb.NATIVE_LZ4HC, 16), (nb.NATIVE_SNAPPY, 0)],
)
def test_pipeline_roundtrip(shuffle_mode, codec, depth):
    n = 3 * 65536 + 12345  # ragged last block
    d = (np.sin(np.arange((n + 3) // 4) * 0.01) * 1000).astype(
        np.float32
    ).tobytes()[:n]
    bs = 65536
    payloads, memf = nb.compress_blocks(d, bs, 4, shuffle_mode, codec, depth)
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
    joined = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    mem = np.array(memf, dtype=np.uint8)
    out = nb.decompress_blocks(
        joined, offs, sizes, mem, bs, n, 4, shuffle_mode, codec
    )
    assert out == d


def test_pipeline_memcpy_fallback_on_random():
    n = 4 * 8192
    d = _data(n, "rand")
    payloads, memf = nb.compress_blocks(d, 8192, 4, 1, nb.NATIVE_LZ4, 1)
    assert all(memf)  # random data is incompressible → every block memcpy
    assert all(len(p) == 8192 for p in payloads)
    # raw bytes stored pre-shuffle
    assert b"".join(payloads) == d


# ---------------------------------------------------------------------------
# end-to-end through the public API (native pipeline engaged via chunk.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", [blosc.LZ4, blosc.LZ4HC, blosc.SNAPPY])
@pytest.mark.parametrize("shuffle", [blosc.NOSHUFFLE, blosc.SHUFFLE, blosc.BITSHUFFLE])
def test_chunked_api_native(codec, shuffle):
    d = np.arange(200_000, dtype=np.float32).tobytes()
    comp = blosc.compress_with_options(
        d,
        blosc.Options(
            codec=codec, shuffle=shuffle, type_size=4, block_size=65536
        ),
    )
    assert blosc.decompress(comp) == d


def test_chunked_api_native_matches_python_frames():
    """Frames built by the native pipeline decode via the pure-Python path
    and vice versa (set TPU_BLOSC_NO_NATIVE to build the python frame)."""
    d = np.arange(50_000, dtype=np.float32).tobytes()
    comp_native = blosc.compress_with_options(
        d, blosc.Options(block_size=32768)
    )
    # python decode of native frame: force the non-native branch by
    # decoding a frame with a codec the native pipeline also covers, then
    # compare against full python decode through internal entry points
    from tpu_blosc import chunk
    from tpu_blosc.format import parse_header

    header = parse_header(comp_native)
    entries, offset = chunk.parse_block_table(comp_native, header)
    # python per-block decode
    pos = 0
    out = bytearray()
    from tpu_blosc.codecs.registry import get_codec

    dec = get_codec(header.codec)
    o = offset
    for psize, is_memcpy in entries:
        this = min(header.block_size, len(d) - pos)
        payload = comp_native[o : o + psize]
        o += psize
        if is_memcpy:
            out += payload
        else:
            blockdata = dec.decompress(payload, this)
            blockdata = chunk._unfilter_block(blockdata, header.type_size, header.flags)
            out += blockdata
        pos += this
    assert bytes(out) == d


# ---------------------------------------------------------------------------
# LZ4 end-of-block spec enforcement in the record emitter
# ---------------------------------------------------------------------------


def test_emit_mixed_rejects_match_starting_in_last_12_bytes():
    """The LZ4 block spec requires the last match to START >= 12 bytes
    before end-of-block; the emitter must reject such records even though
    tpu_blosc producers never generate them (round-2 advisor, low)."""
    n, seg = 64, 64
    p = 54  # in (n-12, n-9]: end-rule-legal (ends at 58 <= n-5) but
    #         start-rule-illegal (54 > n-12 = 52)
    lit_pos = np.concatenate(
        [np.arange(p), np.arange(58, n)]
    ).astype(np.int64)
    lit_bytes = np.arange(lit_pos.size, dtype=np.uint8)
    row_d = np.array([1], np.int32)
    with pytest.raises(RuntimeError):
        nb.lz4_emit_mixed(lit_pos, lit_bytes, row_d, seg, n)


def test_emit_mixed_accepts_match_ending_at_spec_boundary():
    """A match starting at exactly n-12 is the last legal start; the
    emitter must accept it and the stream must decode everywhere."""
    n, seg = 64, 64
    p = n - 12
    lit_pos = np.concatenate(
        [np.arange(p), np.arange(p + 4, n)]
    ).astype(np.int64)
    vals = (np.arange(n) % 7).astype(np.uint8)
    lit_bytes = vals[lit_pos]
    row_d = np.array([7], np.int32)
    stream = nb.lz4_emit_mixed(lit_pos, lit_bytes, row_d, seg, n)
    assert stream is not None
    out = lz4_ref.decompress_block(stream, n)
    expect = vals.copy()
    expect[p : p + 4] = expect[p - 7 : p - 7 + 4]
    assert bytes(out) == expect.tobytes()


# ---------------------------------------------------------------------------
# fixed-offset scan LZ4 encoder (engages inside the block pipelines)
# ---------------------------------------------------------------------------


def _pipeline_lz4(data: bytes, bs: int = 1024 * 1024) -> list[bytes]:
    payloads, memf = nb.compress_blocks(
        np.frombuffer(data, np.uint8), bs, 1, 0, nb.NATIVE_LZ4, 1
    )
    assert not any(memf)
    return payloads


@pytest.mark.parametrize("period", [3, 96, 32, 384])
def test_scan_encoder_periodic_roundtrip(period):
    """Periodic streams (incl. NON-pow2 3-byte and 96-byte struct pitches)
    compress via the scan path and decode with both decoders."""
    rng = np.random.default_rng(period)
    n = 1024 * 1024
    pattern = rng.integers(0, 256, period, np.uint8)
    data = np.tile(pattern, n // period + 1)[:n].copy()
    # clumped noise spans (the scan's home turf: dense break regions the
    # greedy encoder cannot bridge either)
    starts = rng.choice(n - 8, n // 256, replace=False)
    for w in range(6):
        data[starts + w] ^= rng.integers(1, 256, starts.size, np.uint8)
    raw = data.tobytes()
    (stream,) = _pipeline_lz4(raw)
    # decodes with the native decoder AND the from-scratch Python decoder
    out = nb.lz4_decompress(np.frombuffer(stream, np.uint8), n)
    assert out == raw
    assert lz4_ref.decompress_block(stream, n) == raw
    # the scan path must not LOSE to greedy on its home turf
    import os
    import subprocess
    import sys

    code = (
        "import numpy as np, sys; sys.path.insert(0, '/root/repo');"
        "from tpu_blosc.native import backend as nb;"
        "d = np.frombuffer(sys.stdin.buffer.read(), np.uint8);"
        "p, m = nb.compress_blocks(d, %d, 1, 0, nb.NATIVE_LZ4, 1);"
        "print(sum(len(x) for x in p))" % (1024 * 1024)
    )
    env = dict(os.environ, TPU_BLOSC_NO_SCAN="1", TPU_BLOSC_NO_DEVICE="1")
    greedy_total = int(
        subprocess.run(
            [sys.executable, "-c", code], input=raw, capture_output=True,
            env=env, check=True, timeout=300,
        ).stdout
    )
    assert len(stream) <= greedy_total * 1.02, (len(stream), greedy_total)


def test_scan_encoder_respects_end_of_block_rules():
    """Scan output must honor last-5-literals / last-match-start rules for
    every tail shape (prefix sizes straddling the 64-bit mask words)."""
    rng = np.random.default_rng(7)
    base = np.tile(rng.integers(0, 256, 32, np.uint8), 16 * 1024)
    for n in (262144, 262145, 262207, 262208, 524287, 524288 - 63):
        raw = base[:n].tobytes()
        payloads, memf = nb.compress_blocks(
            np.frombuffer(raw, np.uint8), n, 1, 0, nb.NATIVE_LZ4, 1
        )
        stream = payloads[0]
        if not memf[0]:
            assert lz4_ref.decompress_block(stream, n) == raw


def test_scan_encoder_declines_random_and_runs():
    """Random data and long-run data must take the greedy path (identical
    output with and without TPU_BLOSC_NO_SCAN would over-test; we assert
    the cheap observable: valid streams + sane sizes)."""
    rng = np.random.default_rng(3)
    n = 512 * 1024
    rand = rng.integers(0, 256, n, np.uint8).tobytes()
    payloads, memf = nb.compress_blocks(
        np.frombuffer(rand, np.uint8), n, 1, 0, nb.NATIVE_LZ4, 1
    )
    assert memf[0]  # incompressible: memcpy fallback as before
    runs = np.repeat(rng.integers(0, 256, 512, np.uint8), n // 512).tobytes()
    (stream,) = _pipeline_lz4(runs, n)
    assert lz4_ref.decompress_block(stream, n) == runs
    assert len(stream) < n // 100


def test_scan_encoder_declines_isolated_corruption():
    """Lone corrupted bytes in periodic data are greedy's home turf (it
    bridges them at 2x the offset); the probe's isolated-break counter
    must send such blocks to the greedy path, keeping compressed size at
    (or under) what the reference's greedy encoder would produce."""
    rng = np.random.default_rng(11)
    n = 1024 * 1024
    data = np.tile(rng.integers(0, 256, 96, np.uint8), n // 96 + 1)[:n].copy()
    hits = rng.choice(n, n // 64, replace=False)
    data[hits] ^= 0x5A
    raw = data.tobytes()
    (stream,) = _pipeline_lz4(raw)
    greedy = nb.lz4_compress(np.frombuffer(raw, np.uint8), depth=1)
    assert len(stream) <= len(greedy) * 1.02
    assert lz4_ref.decompress_block(stream, n) == raw


def test_pair_interleaved_pipeline_byte_identical_to_single():
    """The pair-interleaved greedy path must produce blocks byte-identical
    to independent single-block encodes (same algorithm, same inserts)."""
    rng = np.random.default_rng(5)
    parts = []
    for kind in ("ramp", "rand", "period3", "ramp", "zeros"):
        parts.append(np.frombuffer(_data(65536, kind), np.uint8))
    d = np.concatenate(parts)  # 5 blocks -> 2 pairs + odd tail
    payloads, memf = nb.compress_blocks(d, 65536, 1, 0, nb.NATIVE_LZ4, 1)
    for i in range(5):
        blk = d[i * 65536 : (i + 1) * 65536].tobytes()
        single = nb.lz4_compress(np.frombuffer(blk, np.uint8), depth=1)
        if memf[i]:
            assert len(single) >= 65536  # single also incompressible
            assert payloads[i] == blk
        else:
            assert payloads[i] == single, f"block {i} diverged"


# ---------------------------------------------------------------------------
# mask_positions vs the NumPy oracle (device.py _unpack_positions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbytes", [0, 1, 7, 8, 9, 64, 1003, 1 << 16])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.5, 1.0])
def test_mask_positions_matches_oracle(nbytes, density):
    from tpu_blosc.device import _unpack_positions

    rng = np.random.default_rng(nbytes + int(density * 100))
    mask = np.packbits(
        rng.random(nbytes * 8) < density, bitorder="little"
    ).astype(np.uint8)[:nbytes]
    want = _unpack_positions(mask)
    got = nb.mask_positions(mask, int(want.size))
    assert got is not None
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_mask_positions_overflow_returns_none():
    mask = np.full(16, 0xFF, np.uint8)  # 128 set bits
    assert nb.mask_positions(mask, 127) is None
    got = nb.mask_positions(mask, 128)
    np.testing.assert_array_equal(got, np.arange(128, dtype=np.int32))


def test_build_key_tracks_the_host(monkeypatch):
    """A library built for another CPU (or from other sources) sits under
    another key and is never loaded here."""
    key = nb.build_key()
    assert key == nb.build_key()
    monkeypatch.setattr(nb, "_cpu_features", lambda: "sse2 another-cpu")
    assert nb.build_key() != key
    monkeypatch.undo()
    monkeypatch.setattr(nb.platform, "machine", lambda: "another-arch")
    assert nb.build_key() != key


def test_library_loads_from_this_hosts_build():
    if not nb.available():
        pytest.skip("native backend unavailable")
    info = nb.build_info()
    if nb._LIB_OVERRIDE:
        assert info["path"] == nb._LIB_OVERRIDE
    else:
        want = os.path.join(nb._BUILD_ROOT, nb.build_key(), "libtpublosc.so")
        assert info["path"] == want and os.path.exists(want)
        assert "error" not in info


def test_build_command_reports_json():
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "tpu_blosc.native"], cwd=root,
        capture_output=True, text=True, timeout=900,
    )
    info = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == (0 if info["available"] else 1)
    assert info["available"] == nb.available()
