"""Streaming file API: appendable record files (stream.py).

The reference has no file/streaming layer (SURVEY §5); this is the
capability-plus data-loader surface from the round-1 verdict's stretch
item: incremental writes, reopen-append, random access via the index
footer, sequential-scan recovery when the footer is missing.
"""

import os
import struct

import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc.errors import InvalidHeaderError
from tpu_blosc.stream import FOOTER_MAGIC, StreamReader, StreamWriter


def _chunks():
    rng = np.random.default_rng(42)
    return [
        np.arange(30_000, dtype=np.float32).tobytes(),
        rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes(),
        (np.arange(50_000, dtype=np.int16) % 100).tobytes(),
    ]


def test_stream_roundtrip(tmp_path):
    path = tmp_path / "s.tpbs"
    chunks = _chunks()
    with StreamWriter(path) as w:
        for i, c in enumerate(chunks):
            assert w.write(c) == i
        assert len(w) == len(chunks)
    with StreamReader(path) as r:
        assert len(r) == len(chunks)
        for i, c in enumerate(chunks):
            assert r.read(i) == c
        assert list(r) == chunks
        assert r[1] == chunks[1]
        comp, orig = zip(*r.sizes())
        assert list(orig) == [len(c) for c in chunks]


def test_stream_append_reopen(tmp_path):
    path = tmp_path / "s.tpbs"
    chunks = _chunks()
    with StreamWriter(path) as w:
        w.write(chunks[0])
    with StreamWriter(path, append=True) as w:
        assert len(w) == 1  # existing records visible
        w.write(chunks[1])
        w.write(chunks[2])
    with StreamReader(path) as r:
        assert list(r) == chunks


def test_stream_footer_recovery(tmp_path):
    """A crashed writer (no footer) still opens via sequential scan."""
    path = tmp_path / "s.tpbs"
    chunks = _chunks()
    with StreamWriter(path) as w:
        for c in chunks:
            w.write(c)
    raw = path.read_bytes()
    assert raw.endswith(FOOTER_MAGIC)
    (index_size,) = struct.unpack("<Q", raw[-12:-4])
    path.write_bytes(raw[: len(raw) - index_size])  # strip the footer
    with StreamReader(path) as r:
        assert list(r) == chunks
    # and appending to the stripped file works
    with StreamWriter(path, append=True) as w:
        w.write(b"tail-record-data" * 100)
    with StreamReader(path) as r:
        assert len(r) == len(chunks) + 1


def test_stream_partial_trailing_record(tmp_path):
    """A torn final record is dropped, intact records survive."""
    path = tmp_path / "s.tpbs"
    chunks = _chunks()
    with StreamWriter(path) as w:
        for c in chunks:
            w.write(c)
    raw = path.read_bytes()
    (index_size,) = struct.unpack("<Q", raw[-12:-4])
    data = raw[: len(raw) - index_size]
    path.write_bytes(data[:-7])  # tear the last record
    with StreamReader(path) as r:
        assert len(r) == len(chunks) - 1
        assert r.read(0) == chunks[0]


def test_stream_arrays(tmp_path):
    path = tmp_path / "a.tpbs"
    arr = np.linspace(0, 1, 500_000, dtype=np.float32)
    with StreamWriter(path, blosc.Options(block_size=262144)) as w:
        w.write_array(arr)
    with StreamReader(path) as r:
        out = r.read_array(0, np.float32)
        assert np.array_equal(np.asarray(out), arr)


def test_stream_read_array_forwards_strategy(tmp_path, monkeypatch):
    """A non-default strategy must reach device.decompress_array (round-3
    advisor finding: the kwarg was documented but dropped)."""
    path = tmp_path / "s.tpbs"
    arr = np.arange(10_000, dtype=np.float32)
    with StreamWriter(path, blosc.Options()) as w:
        w.write_array(arr)
    seen = {}
    from tpu_blosc import device as tbdevice

    real = tbdevice.decompress_array

    def spy(data, dtype, shape=None, sharding=None, strategy="auto"):
        seen["strategy"] = strategy
        return real(data, dtype, shape=shape, sharding=sharding,
                    strategy=strategy)

    monkeypatch.setattr(tbdevice, "decompress_array", spy)
    with StreamReader(path) as r:
        out = r.read_array(0, np.float32, strategy="transfer")
    assert seen["strategy"] == "transfer"
    assert np.array_equal(np.asarray(out), arr)


def test_stream_save_load_convenience(tmp_path):
    path = tmp_path / "c.tpbs"
    data = os.urandom(5000)
    blosc.save(path, data)
    assert blosc.load(path) == data
    arr = np.arange(100_000, dtype=np.float64)
    blosc.save_array(tmp_path / "d.tpbs", arr, blosc.Options(type_size=8))
    out = blosc.load_array(tmp_path / "d.tpbs", np.float64)
    assert np.array_equal(np.asarray(out), arr)


def test_stream_not_a_stream(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(b"not a stream at all")
    with pytest.raises(InvalidHeaderError):
        StreamReader(path)


def test_stream_bad_version(tmp_path):
    path = tmp_path / "v.tpbs"
    path.write_bytes(b"TPBS\x09\x00\x00\x00")
    with pytest.raises(InvalidHeaderError):
        StreamReader(path)


def test_stream_index_errors(tmp_path):
    path = tmp_path / "s.tpbs"
    with StreamWriter(path) as w:
        w.write(b"x" * 100)
    with StreamReader(path) as r:
        with pytest.raises(IndexError):
            r.read(5)
    with pytest.raises(ValueError):
        w.write(b"after close")


def test_stream_container_records(tmp_path):
    """Records can be TPB2 containers (route through decompress)."""
    from tpu_blosc import container

    path = tmp_path / "big.tpbs"
    data = np.arange(200_000, dtype=np.float32).tobytes()
    frame = container.compress_container(
        data, blosc.Options(block_size=65536), frame_limit=131072
    )
    with StreamWriter(path) as w:
        w.write_frame(frame)
    with StreamReader(path) as r:
        assert r.read(0) == data


# ---------------------------------------------------------------------------
# corruption fuzz: no crashes, no silent wrong data
# ---------------------------------------------------------------------------

from hypothesis import given, settings, strategies as st


@settings(max_examples=120, deadline=None)
@given(st.data())
def test_stream_corruption_never_crashes(tmp_path_factory, data):
    """Random byte flips / truncations: StreamReader either raises a
    BloscError/IndexError family error or returns correct data for the
    records that survive — never crashes, never hangs."""
    tmp = tmp_path_factory.mktemp("fuzz")
    path = tmp / "f.tpbs"
    chunks = [b"alpha" * 200, b"beta" * 500, bytes(range(256)) * 8]
    with StreamWriter(path) as w:
        for c in chunks:
            w.write(c)
    raw = bytearray(path.read_bytes())
    mode = data.draw(st.sampled_from(["flip", "truncate", "garbage-tail"]))
    if mode == "flip":
        i = data.draw(st.integers(0, len(raw) - 1))
        raw[i] ^= data.draw(st.integers(1, 255))
    elif mode == "truncate":
        raw = raw[: data.draw(st.integers(0, len(raw)))]
    else:
        raw += bytes(data.draw(st.binary(max_size=64)))
    path.write_bytes(bytes(raw))
    try:
        with StreamReader(path) as r:
            for i in range(len(r)):
                try:
                    out = r.read(i)
                except blosc.BloscError:
                    continue
                # a record that decodes must decode to SOMETHING bounded
                assert len(out) < 10_000_000
    except (blosc.BloscError, IndexError):
        pass


def test_stream_iter_arrays_prefetch(tmp_path):
    """Prefetching device iterator yields every record in order."""
    path = tmp_path / "it.tpbs"
    batches = [
        np.arange(i * 100, i * 100 + 25_000, dtype=np.float32)
        for i in range(6)
    ]
    with StreamWriter(path, blosc.Options(block_size=32768)) as w:
        for b in batches:
            w.write(b.tobytes())
    with StreamReader(path) as r:
        it = r.iter_arrays(np.float32, prefetch=3)
        assert len(it) == 6
        out = list(it)
        for got, want in zip(out, batches):
            assert np.array_equal(np.asarray(got), want)
        # iterable is re-usable
        assert len(list(it)) == 6


def test_stream_iter_prefetch_abandoned_consumer_stops_producer():
    """Regression (round-2 advisor): abandoning iteration with the queue
    full must not leave the producer thread blocked in q.put forever."""
    import threading
    import time

    from tpu_blosc.stream import _iter_prefetch

    before = set(threading.enumerate())

    it = _iter_prefetch(lambda i: i, 1000, prefetch=1)
    next(it)  # start the producer; queue (maxsize 1) fills behind us
    time.sleep(0.2)  # let the producer reach the blocking q.put
    it.close()  # abandon: generator finally sets stop
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        leaked = [
            t for t in threading.enumerate()
            if t not in before and t.is_alive()
        ]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, (
        "prefetch producer thread leaked after consumer abandonment"
    )


def test_stream_iter_arrays_error_propagates(tmp_path):
    path = tmp_path / "bad.tpbs"
    with StreamWriter(path) as w:
        w.write(b"ok" * 5000)
    raw = bytearray(path.read_bytes())
    raw[40] ^= 0xFF  # corrupt inside the first record payload
    path.write_bytes(bytes(raw))
    with StreamReader(path) as r:
        with pytest.raises(Exception):
            for _ in r.iter_arrays(np.uint8):
                pass


# ---------------------------------------------------------------------------
# dictionary streams
# ---------------------------------------------------------------------------


def _jsonish_records(n=40):
    rng = np.random.default_rng(13)
    return [
        (
            b'{"user_id": %d, "event": "click", "ts": 1700000%03d, '
            b'"session": "abcdef%04d", "payload": {"x": %d, "y": %d}}'
            % (int(rng.integers(1e6)), i, i, int(rng.integers(1920)),
               int(rng.integers(1080)))
        ) * 8
        for i in range(n)
    ]


def test_stream_dict_training_roundtrip(tmp_path):
    path = tmp_path / "d.tpbs"
    recs = _jsonish_records()
    with StreamWriter(path, train_dict=16) as w:
        for r in recs:
            w.write(r)
        assert len(w) == len(recs)
    with StreamReader(path) as r:
        assert len(r) == len(recs)
        assert list(r) == recs
        # dict actually engaged: ratio beats the plain stream
    plain = tmp_path / "p.tpbs"
    with StreamWriter(plain) as w:
        for rec in recs:
            w.write(rec)
    assert path.stat().st_size < plain.stat().st_size


def test_stream_dict_append_reuses_dict(tmp_path):
    path = tmp_path / "d.tpbs"
    recs = _jsonish_records(30)
    with StreamWriter(path, train_dict=10) as w:
        for r in recs[:20]:
            w.write(r)
    with StreamWriter(path, append=True) as w:
        for r in recs[20:]:
            w.write(r)
    with StreamReader(path) as r:
        assert list(r) == recs


def test_stream_dict_mixed_records(tmp_path):
    """write_frame/write_array records stay plain alongside dict records."""
    path = tmp_path / "m.tpbs"
    recs = _jsonish_records(12)
    arr = np.arange(30_000, dtype=np.float32)
    with StreamWriter(path, train_dict=8) as w:
        for r in recs[:6]:
            w.write(r)
        w.write_array(arr)  # buffered as a plain frame, order preserved
        for r in recs[6:]:
            w.write(r)
    with StreamReader(path) as r:
        assert len(r) == 13
        for i in range(6):
            assert r.read(i) == recs[i]
        assert r.read(6) == arr.tobytes()
        got = r.read_array(6, np.float32)
        assert np.array_equal(np.asarray(got), arr)
        for i in range(6, 12):
            assert r.read(i + 1) == recs[i]
        comp, orig = zip(*r.sizes())
        assert orig[6] == arr.nbytes


def test_stream_dict_pretrained(tmp_path):
    import zstandard as zstd

    recs = _jsonish_records(25)
    d = zstd.train_dictionary(16384, recs).as_bytes()
    path = tmp_path / "pre.tpbs"
    with StreamWriter(path, dictionary=d) as w:
        for r in recs:
            w.write(r)
    with StreamReader(path) as r:
        assert list(r) == recs


def test_stream_dict_too_few_samples_falls_back(tmp_path):
    """Closing before the training target: plain frames, still readable."""
    path = tmp_path / "few.tpbs"
    with StreamWriter(path, train_dict=100) as w:
        w.write(b"only" * 100)
        w.write(b"three" * 100)
        w.write(b"records" * 100)
    with StreamReader(path) as r:
        assert len(r) == 3
        assert r.read(2) == b"records" * 100


def test_stream_dict_record_forged_size_rejected(tmp_path):
    """A forged orig-size field in a dictionary record must be rejected
    against the zstd frame header before any allocation."""
    import struct

    from tpu_blosc.errors import BloscError

    from tpu_blosc import stream

    path = tmp_path / "forge.tpbs"
    samples = [bytes([i] * 50) + b"shared-structure" * 20 for i in range(16)]
    with stream.StreamWriter(path, train_dict=8) as w:
        for s in samples:
            w.write(s)
    # corrupt record 3's orig field in place (records are length-prefixed)
    blob = bytearray(path.read_bytes())
    with stream.StreamReader(path) as r:
        off = r._offsets[3]
        (flen,) = struct.unpack_from("<Q", blob, off)
        frame = bytes(blob[off + 8 : off + 8 + flen])
        assert frame[:4] == stream.DICT_MAGIC  # dict mode engaged
    blob[off + 8 + 5 : off + 8 + 13] = struct.pack("<Q", 1 << 50)
    path.write_bytes(bytes(blob))
    with stream.StreamReader(path) as r:
        with pytest.raises(BloscError):
            r.read(3)
        assert r.read(4) == samples[4]  # neighbours unaffected


def test_stream_checksum_roundtrip_and_detection(tmp_path):
    """checksum=True streams verify every record on read; a flipped bit
    inside a compressed payload (which can decode to plausible garbage)
    is caught by the crc."""
    path = tmp_path / "crc.tpbs"
    recs = [np.arange(2000 + i, dtype=np.int32).tobytes() for i in range(5)]
    with StreamWriter(path, checksum=True) as w:
        for rec in recs:
            w.write(rec)
    with StreamReader(path) as r:
        assert [r.read(i) for i in range(len(r))] == recs
        off = r._offsets[2]
    blob = bytearray(path.read_bytes())
    blob[off + 8 + 20] ^= 0xFF  # flip a payload byte of record 2
    path.write_bytes(bytes(blob))
    with StreamReader(path) as r:
        with pytest.raises(blosc.BloscError, match="checksum"):
            r.read(2)
        assert r.read(1) == recs[1]  # neighbours still verify


def test_stream_checksum_append_adopts_flag(tmp_path):
    path = tmp_path / "crc2.tpbs"
    with StreamWriter(path, checksum=True) as w:
        w.write(b"first" * 100)
    # append without asking for checksums: the file's flag wins
    with StreamWriter(path, append=True) as w:
        w.write(b"second" * 100)
    with StreamReader(path) as r:
        assert r._crc
        assert r.read(0) == b"first" * 100
        assert r.read(1) == b"second" * 100


def test_stream_checksum_footerless_scan(tmp_path):
    """Crash recovery (footer missing) must still step crc records."""
    path = tmp_path / "crc3.tpbs"
    with StreamWriter(path, checksum=True) as w:
        w.write(b"alpha" * 200)
        w.write(b"beta" * 300)
    blob = path.read_bytes()
    # strip the footer entirely (simulated crash before close)
    import struct as _s

    (index_size,) = _s.unpack("<Q", blob[-12:-4])
    path.write_bytes(blob[: len(blob) - index_size])
    with StreamReader(path) as r:
        assert len(r) == 2
        assert r.read(0) == b"alpha" * 200
        assert r.read(1) == b"beta" * 300


def test_stream_checksum_with_dictionary(tmp_path):
    path = tmp_path / "crc4.tpbs"
    recs = [bytes([i] * 30) + b"shared-shape" * 25 for i in range(12)]
    with StreamWriter(path, train_dict=6, checksum=True) as w:
        for rec in recs:
            w.write(rec)
    with StreamReader(path) as r:
        assert [r.read(i) for i in range(len(r))] == recs


def test_stream_verify_sweep(tmp_path):
    path = tmp_path / "v.tpbs"
    with StreamWriter(path, checksum=True) as w:
        for i in range(4):
            w.write(bytes([i]) * 5000)
    with StreamReader(path) as r:
        assert r.verify() == 4
        assert r.verify(deep=True) == 4
        off = r._offsets[3]
    blob = bytearray(path.read_bytes())
    blob[off + 8 + 2] ^= 0x10
    path.write_bytes(bytes(blob))
    with StreamReader(path) as r:
        with pytest.raises(blosc.BloscError):
            r.verify()


def test_stream_read_range(tmp_path):
    path = tmp_path / "rr.tpbs"
    data = np.arange(200_000, dtype=np.int32).tobytes()
    from tpu_blosc.options import Options

    with StreamWriter(path, Options(block_size=16384, type_size=4)) as w:
        w.write(data)
    with StreamReader(path) as r:
        assert r.read_range(0, 100_000, 5000) == data[100_000:105_000]
        assert r.read_range(0, 0, 0) == b""


def test_stream_dict_definition_corruption_detected(tmp_path):
    """A corrupted dictionary DEFINITION record (excluded from the index)
    must be caught by the crc — both on read and in verify()."""
    from tpu_blosc import stream as _stream

    path = tmp_path / "dictcrc.tpbs"
    samples = [bytes([i] * 40) + b"common-structure" * 30 for i in range(16)]
    with StreamWriter(path, train_dict=8, checksum=True) as w:
        for s in samples:
            w.write(s)
    # locate the definition record (first record region, before offset[0])
    blob = bytearray(path.read_bytes())
    import struct as _s

    pos = _stream.HEADER_SIZE
    (flen,) = _s.unpack_from("<Q", blob, pos)
    assert blob[pos + 8 : pos + 12] == _stream.DICT_MAGIC
    assert blob[pos + 12] == 0  # definition kind
    blob[pos + 8 + 20] ^= 0xFF  # corrupt dictionary content
    path.write_bytes(bytes(blob))
    with StreamReader(path) as r:
        with pytest.raises(blosc.BloscError, match="checksum"):
            r.read(0)
        with pytest.raises(blosc.BloscError, match="checksum"):
            r.verify()


def test_stream_read_range_dict_record_bounds(tmp_path):
    """read_range on dict-compressed records enforces the same bounds
    contract as decompress_range (raise, never truncate)."""
    path = tmp_path / "rrd.tpbs"
    samples = [bytes([i] * 40) + b"shared-shape" * 40 for i in range(12)]
    with StreamWriter(path, train_dict=6) as w:
        for s in samples:
            w.write(s)
    with StreamReader(path) as r:
        n = len(samples[3])
        assert r.read_range(3, 5, 20) == samples[3][5:25]
        with pytest.raises(blosc.BloscError):
            r.read_range(3, n - 1, 2)
        with pytest.raises(blosc.BloscError):
            r.read_range(3, -1, 2)


def test_stream_write_many_bytes_identical(tmp_path):
    """write_many must produce a byte-identical FILE to per-record write()."""
    chunks = _chunks() + [b"small" * 10, bytes(400_000)]
    a, b = tmp_path / "a.tpbs", tmp_path / "b.tpbs"
    with StreamWriter(a, checksum=True) as w:
        idxs = w.write_many(chunks)
        assert idxs == list(range(len(chunks)))
    with StreamWriter(b, checksum=True) as w:
        for c in chunks:
            w.write(c)
    assert a.read_bytes() == b.read_bytes()
    with StreamReader(a) as r:
        assert r.read_many() == chunks
        assert r.read_many([2, 0]) == [chunks[2], chunks[0]]


def test_stream_write_many_dict_mode_falls_back(tmp_path):
    """Training/dictionary streams keep per-record dict compression."""
    recs = [b"common prefix abcdef " + bytes([i]) * 40 for i in range(12)]
    path = tmp_path / "d.tpbs"
    with StreamWriter(path, train_dict=8) as w:
        w.write_many(recs)
    with StreamReader(path) as r:
        assert r.read_many() == recs
        assert [r.read(i) for i in range(len(r))] == recs


def test_checkpoint_batched_save_matches_per_leaf_bytes(tmp_path):
    """save_pytree's batched writer must keep the exact file bytes of the
    per-leaf path (frames are byte-equal, emission order is leaf order)."""
    from tpu_blosc import checkpoint
    from tpu_blosc.options import Options

    rng = np.random.default_rng(3)
    tree = {
        "w": np.arange(5000, dtype=np.float32),
        "b": rng.standard_normal(64).astype(np.float64),
        "step": 7,
        "layers": [
            {"k": np.arange(100, dtype=np.int16)},
            {"k": np.arange(200, dtype=np.int16) * 2},
        ],
    }
    p1 = tmp_path / "batched.ckpt"
    checkpoint.save_pytree(p1, tree, checksum=True)
    # per-leaf reference file: same records via the scalar write() path
    leaves: list = []
    skeleton = checkpoint._encode(tree, leaves)
    import json

    manifest = json.dumps(
        {"version": checkpoint._MANIFEST_VERSION, "tree": skeleton,
         "leaves": len(leaves)}
    ).encode()
    p2 = tmp_path / "scalar.ckpt"
    with StreamWriter(p2, checksum=True) as w:
        w.write(manifest, Options(type_size=1))
        for leaf in leaves:
            w.write(np.ascontiguousarray(leaf),
                    Options(type_size=np.dtype(leaf.dtype).itemsize))
    assert p1.read_bytes() == p2.read_bytes()
    loaded = checkpoint.load_pytree(p1)
    assert loaded["step"] == 7
    np.testing.assert_array_equal(loaded["w"], tree["w"])
    np.testing.assert_array_equal(loaded["layers"][1]["k"],
                                  tree["layers"][1]["k"])


def test_stream_peek_size(tmp_path):
    path = tmp_path / "p.tpbs"
    chunks = [np.arange(1000, dtype=np.float32).tobytes(), b"xy" * 600]
    with StreamWriter(path) as w:
        w.write_many(chunks)
    with StreamReader(path) as r:
        assert [r.peek_size(i) for i in range(2)] == [len(c) for c in chunks]
        with pytest.raises(IndexError):
            r.peek_size(5)


def test_checkpoint_forged_manifest_shape_does_not_preallocate(tmp_path):
    """A manifest claiming a huge leaf shape must not drive allocation —
    the loader falls back to the per-leaf path, whose error is typed."""
    import json

    from tpu_blosc import checkpoint
    from tpu_blosc.options import Options

    leaves = [np.arange(100, dtype=np.float32)]
    skeleton = {"t": "dict", "items": [
        ["w", {"t": "array", "i": 0, "dtype": "float32",
               "shape": [1 << 40]}]]}  # 4 TB claim vs a 400-byte record
    manifest = json.dumps({"version": checkpoint._MANIFEST_VERSION,
                           "tree": skeleton, "leaves": 1}).encode()
    path = tmp_path / "forged.ckpt"
    with StreamWriter(path) as w:
        w.write(manifest, Options(type_size=1))
        w.write(leaves[0], Options(type_size=4))
    with pytest.raises(Exception):  # reshape mismatch, as the old path
        checkpoint.load_pytree(path)


def test_stream_verify_deep_batched_matches_serial_errors(tmp_path):
    """deep verify batches decodes in windows; errors must still surface
    for the FIRST bad record with the same typed error the serial
    read() loop raised."""
    path = tmp_path / "v.tpbs"
    chunks = [np.arange(4000 + i, dtype=np.float32).tobytes() for i in range(6)]
    with StreamWriter(path, checksum=True) as w:
        w.write_many(chunks)
    with StreamReader(path) as r:
        assert r.verify(deep=True) == 6
    # corrupt record 2's payload (recompute its crc so the crc layer
    # passes and the DECODE layer must catch it)
    import zlib as _zlib

    with StreamReader(path) as r:
        off = r._offsets[2]
    raw = bytearray(path.read_bytes())
    (flen,) = struct.unpack_from("<Q", raw, off)
    raw[off + 8 + 30] ^= 0xFF
    frame = bytes(raw[off + 8 : off + 8 + flen])
    struct.pack_into("<I", raw, off + 8 + flen, _zlib.crc32(frame))
    path.write_bytes(bytes(raw))
    with StreamReader(path) as r:
        with pytest.raises(blosc.BloscError):
            r.verify(deep=True)


def test_dictionary_streams_need_zstandard(tmp_path, monkeypatch):
    """Dictionary records are python-zstandard streams: without the module
    the writer refuses up front with a clear error, and so does reading
    a dictionary record."""
    import sys

    import tpu_blosc as blosc
    from tpu_blosc.stream import StreamReader, StreamWriter

    path = tmp_path / "d.tpbs"
    with StreamWriter(path, dictionary=b"\x00" * 1024) as w:
        w.write(b"abc" * 1000)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(blosc.InvalidCodecError, match="zstandard"):
        StreamWriter(tmp_path / "e.tpbs", train_dict=8)
    with StreamReader(path) as r:
        with pytest.raises(blosc.InvalidCodecError, match="zstandard"):
            r.read(0)
