"""compress_array / decompress_array: device-resident array compression.

The contract under test: device filtering is an execution choice, never a
format choice — compress_array frames are BIT-IDENTICAL to the host path
at the same options.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc.options import Options


@pytest.mark.parametrize(
    "dtype", [np.float32, np.float64, np.int16, np.int32]
)
@pytest.mark.parametrize("shuffle", [blosc.SHUFFLE, blosc.BITSHUFFLE])
def test_compress_array_bit_identical_to_host(dtype, shuffle):
    data = (np.arange(100_000) % 1000).astype(dtype)
    ts = data.dtype.itemsize
    opts = Options(shuffle=shuffle, type_size=ts, block_size=65536)
    dev_frame = blosc.compress_array(jnp.asarray(data), opts)
    host_frame = blosc.compress_with_options(data.tobytes(), opts)
    assert dev_frame == host_frame
    assert blosc.decompress(dev_frame) == data.tobytes()


def test_compress_array_default_type_size_from_dtype():
    data = np.arange(50_000, dtype=np.float64)
    frame = blosc.compress_array(jnp.asarray(data))
    info = blosc.get_info(frame)
    assert info.type_size == 8
    assert blosc.decompress(frame) == data.tobytes()


def test_compress_array_small_input_single_block_routing():
    # small inputs follow the host routing (single-block frame)
    data = np.arange(1000, dtype=np.float32)
    frame = blosc.compress_array(jnp.asarray(data))
    host = blosc.compress_with_options(
        data.tobytes(), Options(type_size=4)
    )
    assert frame == host
    assert not blosc.get_info(frame).is_split


def test_compress_array_noshuffle():
    data = np.arange(100_000, dtype=np.int32)
    opts = Options(shuffle=blosc.NOSHUFFLE, type_size=4, block_size=32768)
    frame = blosc.compress_array(jnp.asarray(data), opts)
    assert frame == blosc.compress_with_options(data.tobytes(), opts)


def test_compress_array_incompressible_memcpy_patch():
    # random data: every block takes the memcpy fallback; payloads must be
    # raw PRE-filter bytes (host-path parity)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2**31, 65536, dtype=np.int32)
    opts = Options(shuffle=blosc.SHUFFLE, type_size=4, block_size=32768)
    dev_frame = blosc.compress_array(jnp.asarray(data), opts)
    host_frame = blosc.compress_with_options(data.tobytes(), opts)
    assert dev_frame == host_frame
    assert blosc.decompress(dev_frame) == data.tobytes()


def test_compress_array_ragged_tail():
    data = np.arange(70_001, dtype=np.float32)  # not a block multiple
    opts = Options(block_size=65536, type_size=4)
    dev_frame = blosc.compress_array(jnp.asarray(data), opts)
    assert dev_frame == blosc.compress_with_options(data.tobytes(), opts)


def test_decompress_array_roundtrip():
    data = np.linspace(0, 1, 100_000, dtype=np.float32).reshape(100, 1000)
    frame = blosc.compress_array(jnp.asarray(data), Options(block_size=65536))
    out = blosc.decompress_array(frame, np.float32, shape=(100, 1000))
    assert out.shape == (100, 1000)
    assert np.array_equal(np.asarray(out), data)


def test_decompress_array_dtype_mismatch():
    frame = blosc.compress(b"123", blosc.LZ4, 5, blosc.NOSHUFFLE, 1)
    with pytest.raises(blosc.InvalidDataError):
        blosc.decompress_array(frame, np.float32)


@pytest.mark.parametrize("codec", [blosc.ZSTD, blosc.ZLIB])
def test_compress_array_nonlz4_codecs_identical(codec):
    data = np.arange(80_000, dtype=np.float32)
    opts = Options(codec=codec, type_size=4, block_size=65536)
    assert blosc.compress_array(jnp.asarray(data), opts) == (
        blosc.compress_with_options(data.tobytes(), opts)
    )


def test_compress_array_sharded_over_mesh():
    """A sharded jax.Array compresses transparently — each device filters
    its shard (XLA propagates the sharding through the fused filter jit)
    and the frame is bit-identical to the host path."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()), ("d",))
    data = np.arange(2**21, dtype=np.float32)  # 8 MiB over 8 devices
    x = jax.device_put(data, NamedSharding(mesh, P("d")))
    opts = Options(block_size=1 << 20)
    frame = blosc.compress_array(x, opts)
    assert frame == blosc.compress_with_options(data.tobytes(), opts)
    assert blosc.decompress(frame) == data.tobytes()


def test_decompress_array_with_sharding():
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()), ("d",))
    sharding = NamedSharding(mesh, P("d"))
    data = np.arange(2**20, dtype=np.float32)
    frame = blosc.compress_array(jnp.asarray(data), Options(block_size=1 << 19))
    out = blosc.decompress_array(frame, np.float32, sharding=sharding)
    assert out.sharding == sharding
    assert np.array_equal(np.asarray(out), data)


# ---------------------------------------------------------------------------
# device-RLE strategy: run scan on device, O(runs) host emission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_rle_strategy_roundtrip_and_cross_decode(dtype):
    data = (np.arange(300_000) % 700).astype(dtype)
    opts = Options(type_size=data.dtype.itemsize, block_size=65536)
    frame = blosc.compress_array(jnp.asarray(data), opts, strategy="rle")
    assert blosc.decompress(frame) == data.tobytes()
    # the frame is standard: python-path decode reads it too
    from tpu_blosc import chunk

    orig = chunk._native_pipeline_codec
    chunk._native_pipeline_codec = lambda c, l: None
    try:
        assert blosc.decompress(frame) == data.tobytes()
    finally:
        chunk._native_pipeline_codec = orig


def test_rle_strategy_ratio_parity_with_host():
    data = (np.arange(600_000) % 1000).astype(np.float64)
    opts = Options(type_size=8, block_size=65536)
    frame = blosc.compress_array(jnp.asarray(data), opts, strategy="rle")
    host = blosc.compress_with_options(data.tobytes(), opts)
    # hybrid fallback keeps the ratio within 5% of the full encoder
    assert len(frame) <= int(len(host) * 1.05)


def test_rle_strategy_incompressible_falls_back():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 2**31, 200_000, dtype=np.int32)
    opts = Options(type_size=4, block_size=65536)
    frame = blosc.compress_array(jnp.asarray(data), opts, strategy="rle")
    # falls back to the transfer path -> bit-identical to host
    assert frame == blosc.compress_with_options(data.tobytes(), opts)


def test_rle_strategy_non_lz4_codec_uses_transfer():
    data = (np.arange(100_000) % 100).astype(np.float32)
    opts = Options(codec=blosc.ZSTD, type_size=4, block_size=65536)
    frame = blosc.compress_array(jnp.asarray(data), opts, strategy="rle")
    assert frame == blosc.compress_with_options(data.tobytes(), opts)


def test_rle_strategy_ragged_tail():
    data = (np.arange(70_001) % 90).astype(np.float32)
    opts = Options(type_size=4, block_size=65536)
    frame = blosc.compress_array(jnp.asarray(data), opts, strategy="rle")
    assert blosc.decompress(frame) == data.tobytes()


def test_rle_emitter_vs_reference_decoder():
    from tpu_blosc.codecs import lz4_ref
    from tpu_blosc.native import backend as nb

    if not nb.available():
        pytest.skip("native backend unavailable")
    rng = np.random.default_rng(2)
    for _ in range(20):
        nr = int(rng.integers(1, 40))
        lens = rng.integers(1, 50, nr).astype(np.int64)
        vals = rng.integers(0, 5, nr).astype(np.uint8)
        data = np.repeat(vals, lens).tobytes()
        stream = nb.lz4_emit_runs(vals, lens, len(data))
        assert lz4_ref.decompress_block(stream, len(data)) == data
        assert nb.lz4_decompress(stream, len(data)) == data


def test_decompress_array_rle_path_roundtrip():
    """Run-friendly frames decode via O(runs) records + device repeat."""
    data = ((np.arange(262_144)) // 64).astype(np.float32)
    frame = blosc.compress_with_options(
        data.tobytes(), Options(type_size=4, block_size=65536)
    )
    out = blosc.decompress_array(frame, np.float32)
    assert np.array_equal(np.asarray(out), data)


def test_decompress_array_rle_matches_transfer():
    data = ((np.arange(131_072)) // 32).astype(np.int32)
    frame = blosc.compress_with_options(
        data.tobytes(), Options(type_size=4, block_size=32768)
    )
    rle = blosc.decompress_array(frame, np.int32, strategy="rle")
    plain = blosc.decompress_array(frame, np.int32, strategy="transfer")
    assert np.array_equal(np.asarray(rle), np.asarray(plain))


def test_decompress_array_bitshuffle_rle():
    data = ((np.arange(131_072)) // 128).astype(np.int16)
    frame = blosc.compress_with_options(
        data.tobytes(),
        Options(shuffle=blosc.BITSHUFFLE, type_size=2, block_size=32768),
    )
    out = blosc.decompress_array(frame, np.int16)
    assert np.array_equal(np.asarray(out), data)


def _tiled_pattern(n_elems: int, period: int = 256, noise_pct: int = 100):
    """Dense-but-compressible f32: tiled random pattern + sparse noise.

    After byte shuffle every plane is periodic with period `period` —
    no runs (RLE fails) but constant-offset matches everywhere."""
    rng = np.random.default_rng(5)
    data = np.tile(rng.random(period).astype(np.float32), n_elems // period)
    hit = rng.choice(data.size, max(data.size // noise_pct, 1), replace=False)
    data[hit] += rng.random(hit.size).astype(np.float32) * 0.01
    return data


def test_compress_array_match_strategy_roundtrip():
    """Device match discovery emits valid LZ4 frames that decode everywhere."""
    data = _tiled_pattern(2 * 1024 * 1024)  # 8 MiB
    frame = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    h = blosc.get_info(frame)
    assert h.is_split
    # decodes via the normal host path...
    assert blosc.decompress(frame) == data.tobytes()
    # ...and via the pure-Python oracle decoder, block by block
    from tpu_blosc import chunk as _chunk
    from tpu_blosc.codecs import lz4_ref

    entries, off = _chunk.parse_block_table(frame, h)
    pos = 0
    for psize, is_memcpy in entries:
        payload = frame[off : off + psize]
        off += psize
        bs = min(h.block_size, h.nbytes_orig - pos)
        if not is_memcpy:
            dec = lz4_ref.decompress_block(payload, bs)
            assert len(dec) == bs
        pos += bs


def test_delta_encode_positions_roundtrip():
    """u16 position deltas + device cumsum must visit exactly the real
    positions (dummy split entries marked by keep), including gaps over
    65535 and a first position past 65535."""
    from tpu_blosc import device as dev

    rng = np.random.default_rng(4)
    pos = np.unique(
        np.concatenate([
            rng.integers(0, 1 << 22, 5000),
            np.array([0, 70000, 70001, (1 << 22) - 1]),
            np.array([200000 + 3 * 65535 + 17]),  # forces multi-split gaps
        ])
    ).astype(np.int32)
    du, keep = dev._delta_encode_positions(pos)
    walked = np.cumsum(du.astype(np.int64))
    assert np.array_equal(walked[keep], pos)
    assert keep.sum() == pos.size
    assert du.max() <= 65535
    # the device body reproduces the same gather as the int32 form
    total = 1 << 22
    segs = jnp.asarray(
        rng.integers(0, 256, total, dtype=np.uint8).reshape(64, -1)
    )
    got = np.asarray(dev._device_gather_vals_delta(segs, jnp.asarray(du)))[
        keep
    ]
    want = np.asarray(
        dev._device_gather_vals(segs, jnp.asarray(pos.astype(np.int32)))
    )
    assert np.array_equal(got, want)
    # empty input
    du0, keep0 = dev._delta_encode_positions(np.empty(0, np.int32))
    assert du0.size == 0 and keep0.size == 0


def test_match_frames_identical_with_and_without_delta_pos(monkeypatch):
    """TPU_BLOSC_NO_DELTA_POS (read per call) must not change frame
    bytes — position transport is invisible to the emitted streams."""
    import os

    data = _tiled_pattern(2 * 1024 * 1024)
    a = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    monkeypatch.setitem(os.environ, "TPU_BLOSC_NO_DELTA_POS", "1")
    b = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    assert a == b
    assert blosc.decompress(a) == data.tobytes()


def test_match_frames_identical_with_overlapped_fetch(monkeypatch):
    """The chunked-overlap record fetch (round 5) must produce frames
    byte-identical to the monolithic flow, including when chunks land on
    zero-literal row groups and dense rows (zeroed mask bytes)."""
    import os

    data = _tiled_pattern(2 * 1024 * 1024)  # 8 MiB -> 32 mask rows
    base = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    # force the overlap plan with tiny chunks (2 rows each -> 16 chunks)
    monkeypatch.setitem(os.environ, "TPU_BLOSC_OVERLAP_FETCH_MIN", "0")
    monkeypatch.setitem(
        os.environ, "TPU_BLOSC_OVERLAP_CHUNK_BYTES", str(2 * (256 * 1024 // 8))
    )
    overlapped = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    assert overlapped == base
    assert blosc.decompress(overlapped) == data.tobytes()
    # escape hatch restores the monolithic plan
    monkeypatch.setitem(os.environ, "TPU_BLOSC_NO_OVERLAP_FETCH", "1")
    mono = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    assert mono == base


def test_match_overlapped_fetch_mixed_rows(monkeypatch):
    """Overlap plan with dense rows present: per-chunk counts must skip
    the zeroed dense-row mask bytes."""
    import os

    rng = np.random.default_rng(6)
    n = 2 * 1024 * 1024
    pattern = np.tile(rng.integers(0, 256, 128, np.uint8), n // 128)
    noise = rng.integers(0, 256, n, np.uint8)
    data = (pattern.astype(np.int16) | (noise.astype(np.int16) << 8)).astype(
        np.int16
    )
    base = blosc.compress_array(
        data, Options(type_size=2, block_size=512 * 1024), strategy="match"
    )
    monkeypatch.setitem(os.environ, "TPU_BLOSC_OVERLAP_FETCH_MIN", "0")
    monkeypatch.setitem(
        os.environ, "TPU_BLOSC_OVERLAP_CHUNK_BYTES", str(3 * (256 * 1024 // 8))
    )
    overlapped = blosc.compress_array(
        data, Options(type_size=2, block_size=512 * 1024), strategy="match"
    )
    assert overlapped == base
    assert blosc.decompress(overlapped) == data.tobytes()


def test_compress_array_match_beats_transfer_on_link_bytes():
    """The point of the strategy: record rows ship O(literals), not bytes.
    Assert the frame is materially smaller than the raw bytes AND that the
    emitter path engaged (streams differ from the plain-transfer frame)."""
    from tpu_blosc.native import backend as nb

    if not nb.available():
        pytest.skip("match strategy needs the native emitter")
    data = _tiled_pattern(2 * 1024 * 1024)
    match = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    transfer = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="transfer"
    )
    assert len(match) < data.nbytes // 4
    assert match != transfer  # emitter path actually engaged
    assert blosc.decompress(match) == blosc.decompress(transfer)


def test_compress_array_match_falls_back_on_random():
    """Incompressible data: match returns None internally -> transfer path
    (bit-identical frames)."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 2**31, 2 * 1024 * 1024, dtype=np.int32)  # 8 MiB
    match = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    transfer = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="transfer"
    )
    assert match == transfer
    assert blosc.decompress(match) == data.tobytes()


def test_compress_array_match_mixed_rows():
    """Half the planes periodic, half noisy: record rows + byte rows mix
    inside blocks and the rebuild path produces correct frames."""
    rng = np.random.default_rng(6)
    n = 2 * 1024 * 1024
    pattern = np.tile(rng.integers(0, 256, 128, np.uint8), n // 128)
    noise = rng.integers(0, 256, n, np.uint8)
    # interleave as low/high bytes of int16: plane 0 periodic, plane 1 noisy
    data = (pattern.astype(np.int16) | (noise.astype(np.int16) << 8)).astype(
        np.int16
    )
    frame = blosc.compress_array(
        data, Options(type_size=2, block_size=512 * 1024), strategy="match"
    )
    assert blosc.decompress(frame) == data.tobytes()


def test_compress_array_match_rle_data_still_works():
    """Pure run data (the RLE sweet spot) through the generalized path."""
    data = ((np.arange(1_048_576)) // 64).astype(np.float32)
    frame = blosc.compress_array(
        data, Options(block_size=1024 * 1024), strategy="match"
    )
    assert blosc.decompress(frame) == data.tobytes()


def test_decompress_array_match_records_path():
    """Dense-but-periodic frames decode via O(literal) records + device
    offset-fill (the decode half of the match strategy)."""
    data = _tiled_pattern(1024 * 1024)  # 4 MiB
    frame = blosc.compress_with_options(
        data.tobytes(), Options(type_size=4, block_size=512 * 1024)
    )
    out = blosc.decompress_array(frame, np.float32)
    assert np.array_equal(np.asarray(out), data)
    plain = blosc.decompress_array(frame, np.float32, strategy="transfer")
    assert np.array_equal(np.asarray(out), np.asarray(plain))


def test_compress_array_match_bitshuffle_mode():
    """Match discovery under the bitshuffle filter (int16 pattern data)."""
    rng = np.random.default_rng(8)
    n = 1024 * 1024
    pattern = rng.integers(0, 1 << 12, 64, np.int16)
    data = np.tile(pattern, n // 64)
    frame = blosc.compress_array(
        data,
        Options(shuffle=blosc.BITSHUFFLE, type_size=2, block_size=512 * 1024),
        strategy="match",
    )
    assert blosc.decompress(frame) == data.tobytes()


def test_decompress_array_records_many_offsets_on_device():
    """6 distinct match offsets in one frame: the row-group-chunked fill
    keeps every offset HBM-resident, so the records path decodes on
    device (round 2 fell back to transfer past 4 offsets)."""
    from tpu_blosc.native import backend as nb

    if not nb.available():
        pytest.skip("records strategy needs the native mask emitters")

    from tpu_blosc import device as dv

    rng = np.random.default_rng(21)
    bs = 256 * 1024
    parts = []
    for blk, period in enumerate([4, 8, 16, 32, 64, 128]):
        pattern = rng.random(period).astype(np.float32)
        parts.append(np.tile(pattern, bs // 4 // period))
    data = np.concatenate(parts)
    frame = blosc.compress_with_options(
        data.tobytes(), Options(type_size=4, block_size=bs)
    )
    calls = []
    real = dv._device_match_decode

    def spy(*a, **k):
        calls.append(a[3])  # the offsets tuple
        return real(*a, **k)

    dv._device_match_decode = spy
    try:
        out = blosc.decompress_array(frame, np.float32, strategy="records")
    finally:
        dv._device_match_decode = real
    assert np.array_equal(np.asarray(out), data)
    assert calls and len(calls[0]) >= 5, calls


def test_device_match_decode_huge_segment_no_key_overflow():
    """Regression (round-2 advisor, high): with seg/d >= 2**23 the old
    packed int32-key cummax overflowed to negative and silently dropped
    literals.  The pair-scan fill must stay exact at any segment size."""
    n_elems = 8 * 1024 * 1024  # seg = 16 MiB / 2 = 2**23 rows at d=1
    data = np.full(n_elems, 7, np.uint16)
    rng = np.random.default_rng(0)
    idx = rng.choice(n_elems, 42, replace=False)
    data[idx] = 12345
    frame = blosc.compress_array(
        data,
        Options(type_size=2, block_size=16 * 1024 * 1024),
        strategy="match",
    )
    out = blosc.decompress_array(frame, np.uint16, strategy="records")
    assert np.array_equal(np.asarray(out), data)


# ---------------------------------------------------------------------------
# non-pow2 match offsets (round 3: pow2-only model generalized)
# ---------------------------------------------------------------------------


def _periodic_planes(n_elems: int, period: int, dtype, seed=9):
    """Elements tiled with an ELEMENT period, so every shuffled byte-plane
    row is periodic with that period; plus clumped noise spans."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    pattern = rng.integers(info.min, info.max, period, dtype)
    data = np.tile(pattern, n_elems // period + 1)[:n_elems].copy()
    starts = rng.choice(n_elems - 8, max(n_elems // 512, 1), replace=False)
    for w in range(4):
        data[starts + w] ^= dtype(rng.integers(1, 127))
    return data


def test_match_strategy_3_byte_period():
    """3-element period (a 3-channel interleave): offset 3 is not pow2 and
    never divides the pow2 segment — the generalized candidate list must
    engage and the frame must undercut half the raw bytes (the >=2x
    link-reduction bar), decoding everywhere."""
    from tpu_blosc.native import backend as nb

    if not nb.available():
        pytest.skip("match strategy needs the native emitters (falls back to transfer without them)")

    data = _periodic_planes(1024 * 1024, 3, np.int32)  # 4 MiB
    opts = Options(type_size=4, block_size=512 * 1024)
    frame = blosc.compress_array(data, opts, strategy="match")
    transfer = blosc.compress_array(data, opts, strategy="transfer")
    assert frame != transfer  # emitter path engaged
    assert len(frame) < data.nbytes // 2
    assert blosc.decompress(frame) == data.tobytes()
    # decode half: the padded residue fill reconstructs on device
    out = blosc.decompress_array(frame, np.int32, strategy="records")
    assert np.array_equal(np.asarray(out), data)


def test_match_strategy_96_byte_struct_pitch():
    """96-byte struct records as uint16 (element period 48): 48 = 3*16 is
    in the generalized candidate family."""
    from tpu_blosc.native import backend as nb

    if not nb.available():
        pytest.skip("match strategy needs the native emitters (falls back to transfer without them)")

    data = _periodic_planes(2 * 1024 * 1024, 48, np.uint16)  # 4 MiB
    opts = Options(type_size=2, block_size=512 * 1024)
    frame = blosc.compress_array(data, opts, strategy="match")
    transfer = blosc.compress_array(data, opts, strategy="transfer")
    assert frame != transfer
    assert len(frame) < data.nbytes // 2
    assert blosc.decompress(frame) == data.tobytes()
    out = blosc.decompress_array(frame, np.uint16, strategy="records")
    assert np.array_equal(np.asarray(out), data)


def test_reconstruct_match_row_non_dividing_offset():
    """Unit check: the padded residue reshape fills rows whose length is
    not a multiple of the offset."""
    from tpu_blosc.device import _reconstruct_match_row

    rng = np.random.default_rng(0)
    for seg, d in [(256, 3), (256, 48), (1000, 96), (512, 7)]:
        row = np.tile(rng.integers(0, 256, d, np.uint8), seg // d + 1)[:seg]
        # corrupt some positions and mark them (plus the first d) literal
        lit = np.zeros(seg, bool)
        lit[:d] = True
        bad = rng.choice(np.arange(d, seg), 10, replace=False)
        row = row.copy()
        row[bad] = 77
        lit[bad] = True
        # every non-literal position must satisfy row[i] == row[i-d]
        for i in range(d, seg):
            if not lit[i]:
                row[i] = row[i - d]
        pos = np.flatnonzero(lit)
        got = _reconstruct_match_row(seg, d, pos, row[pos])
        assert np.array_equal(got, row), (seg, d)


def test_match_core_matches_host_oracle():
    """The device match core (plain XLA) agrees with the host oracle:
    per-row best offset (first argmax of equal-pair counts), literal
    counts, and the packed literal mask of every kept row."""
    import jax.numpy as jnp

    from tpu_blosc import device as d

    rng = np.random.default_rng(11)
    seg = 16384
    offs = d._match_offsets(seg)
    nseg = 16
    base = rng.integers(0, 6, (nseg, seg), dtype=np.uint8)
    for i in range(0, nseg, 2):  # half the rows strongly periodic
        dd = offs[(i * 3 + 1) % len(offs)]
        row = base[i]
        keep = rng.random(seg) > 0.01
        for p in range(dd, seg):
            if keep[p]:
                row[p] = row[p - dd]
    segs, best, lit_counts, packed = (
        np.asarray(a) for a in d._device_match_core(jnp.asarray(base), seg, offs)
    )
    assert np.array_equal(segs, base)
    counts = np.stack(
        [(base[:, o:] == base[:, :-o]).sum(axis=1) for o in offs], axis=1
    )
    assert np.array_equal(best, counts.argmax(axis=1))
    d_all = np.asarray(offs, np.int32)[best]
    lit = d._host_lit_mask(base, d_all, d._MATCH_T)
    assert np.array_equal(lit_counts, lit.sum(axis=1))
    kept = lit_counts <= seg // 10
    assert kept.any() and not kept.all()  # both kinds of row exercised
    want = np.packbits(lit & kept[:, None], axis=1, bitorder="little")
    assert np.array_equal(packed, want)


def test_open_mask_bits_matches_byte_oracle():
    """The bit-domain morphological opening (LE-packed u64 ladders) must
    be bit-identical to the byte-domain oracle across densities, shapes,
    and T values — including rows ending in runs (cross-word carries)."""
    from tpu_blosc import device as d

    rng = np.random.default_rng(17)
    for nseg, seg, T, p in [
        (64, 1024, 8, 0.5),
        (16, 4096, 8, 0.97),
        (5, 320, 8, 0.9),
        (100, 128, 8, 0.99),
        (3, 64, 5, 0.3),
        (2, 192, 12, 0.95),
    ]:
        eq = rng.random((nseg, seg)) < p
        ref = d._open_mask_bytes(eq.copy(), T)
        got = d._open_mask_bits(eq.copy(), T)
        assert np.array_equal(ref, got), (nseg, seg, T, p)
        packed = d._open_mask_bits(eq.copy(), T, packed=True)
        unpacked = np.unpackbits(packed, axis=1, bitorder="little")
        assert np.array_equal(unpacked.view(bool), ref)


def test_host_lit_mask_packed_positions_roundtrip():
    """Packed mask + native ctz positions == flatnonzero of the bool
    mask (the decode fast path's exact contract)."""
    from tpu_blosc import device as d
    from tpu_blosc.native import backend as nb

    if not nb.available():
        import pytest

        pytest.skip("native backend unavailable")
    rng = np.random.default_rng(23)
    rows2d = (rng.integers(0, 4, size=(32, 512))).astype(np.uint8)
    d_all = np.full(32, 4, np.int32)
    lit = d._host_lit_mask(rows2d, d_all, d._MATCH_T)
    packed = d._host_lit_mask_packed(rows2d, d_all, d._MATCH_T)
    assert packed is not None
    n_real = int(np.bitwise_count(packed).sum(dtype=np.int64))
    assert n_real == int(lit.sum())
    pos = nb.mask_positions(packed.reshape(-1), n_real)
    assert np.array_equal(pos, np.flatnonzero(lit).astype(np.int32))
