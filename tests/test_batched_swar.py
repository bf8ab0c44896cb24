"""SWAR word-transpose batched filters vs the u8 oracle kernels.

The ts=2/4/8 byte shuffles ride in-register word SWAR (batched._t4x4 and
friends) instead of byte-granular relayouts; these tests pin byte
equality with the generic u8 transpose kernels (which are themselves
pinned against filters/reference.py by the dispatch tests), for every
supported type_size, plus the dtype-matrix of the jitted device prep
(including a ragged tail and bfloat16 — the dominant accelerator dtype).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc import device as tbdev
from tpu_blosc.filters import batched as fb
from tpu_blosc.options import Options

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("ts", [2, 4, 8, 16])
@pytest.mark.parametrize("bs", [4096, 1024, 96])
def test_swar_shuffle_matches_u8_kernel(ts, bs):
    if bs % ts:
        pytest.skip("bs must be a multiple of ts")
    arr = RNG.integers(0, 256, size=(5, bs), dtype=np.uint8)
    ref = np.asarray(fb._shuffle_batch_dev(jnp.asarray(arr), ts))
    got = fb.shuffle_batch(arr, ts)
    assert np.array_equal(ref, got)
    back = fb.unshuffle_batch(got, ts)
    assert np.array_equal(back, arr)


@pytest.mark.parametrize("ts", [2, 4, 8, 16])
def test_swar_unshuffle_matches_u8_kernel(ts):
    arr = RNG.integers(0, 256, size=(3, 2048), dtype=np.uint8)
    ref = np.asarray(fb._unshuffle_batch_dev(jnp.asarray(arr), ts))
    got = fb.unshuffle_batch(arr, ts)
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("ts", [2, 4, 8, 16])
@pytest.mark.parametrize("groups", [32, 8, 1])
def test_swar_bit_shuffle_matches_u8_kernel(ts, groups):
    # bs must be a multiple of 8*ts; parametrize by group count so every
    # combination (including the single-group minimum) is legal.
    bs = groups * 8 * ts
    arr = RNG.integers(0, 256, size=(5, bs), dtype=np.uint8)
    ref = np.asarray(fb._bit_shuffle_batch_dev(jnp.asarray(arr), ts))
    got = fb.bit_shuffle_batch(arr, ts)
    assert np.array_equal(ref, got)
    refu = np.asarray(fb._bit_unshuffle_batch_dev(jnp.asarray(arr), ts))
    gotu = fb.bit_unshuffle_batch(arr, ts)
    assert np.array_equal(refu, gotu)
    assert np.array_equal(fb.bit_unshuffle_batch(got, ts), arr)


@pytest.mark.parametrize(
    "dtype", ["bfloat16", np.float16, np.float32, np.float64]
)
def test_device_prep_bitshuffle_swar_byte_identical(dtype):
    n_el, bs = 4096, 512
    if dtype == "bfloat16":
        x = jnp.asarray(RNG.random(n_el, dtype=np.float32), dtype=jnp.bfloat16)
    else:
        x = jnp.asarray((RNG.random(n_el) * 100).astype(dtype))
    tsz = x.dtype.itemsize
    nb = (n_el * tsz) // bs - 1  # leave a tail
    f8, t8 = tbdev._device_filter_prep(x, nb, bs, tsz, 2, False)
    fw, tw = tbdev._device_filter_prep(x, nb, bs, tsz, 2, True)
    if tsz in (4, 8):
        # SWAR branch engaged; ts=2 stays u8 on device (the widening
        # u16->u32 bitcast materializes lane-padded 64x — see prep)
        assert np.asarray(fw).dtype != np.uint8
    assert (
        np.ascontiguousarray(np.asarray(fw)).tobytes()
        == np.asarray(f8).tobytes()
    )
    assert np.asarray(tw).tobytes() == np.asarray(t8).tobytes()


def test_compress_array_bitshuffle_bit_identical_to_host():
    x = jnp.asarray(np.linspace(0, 1, 200_000), dtype=jnp.float32)
    host_bytes = np.asarray(x).tobytes()
    from tpu_blosc.format import Shuffle

    opts = Options(type_size=4, shuffle=Shuffle.BITSHUFFLE)
    frame_dev = tbdev.compress_array(x, opts)
    frame_host = blosc.compress_with_options(host_bytes, opts)
    assert frame_dev == frame_host
    assert blosc.decompress(frame_dev) == host_bytes


def test_swar_skips_unaligned_block_size():
    # bs=24: multiple of ts=8 but not of the ts=8 SWAR quantum (32) —
    # must fall back to the generic kernel, still correct
    arr = RNG.integers(0, 256, size=(4, 24), dtype=np.uint8)
    ref = np.asarray(fb._shuffle_batch_dev(jnp.asarray(arr), 8))
    assert np.array_equal(fb.shuffle_batch(arr, 8), ref)


@pytest.mark.parametrize(
    "dtype", ["bfloat16", np.float16, np.int16, np.float32, np.uint32]
)
def test_device_prep_swar_byte_identical(dtype):
    n_el, bs = 5000, 512
    if dtype == "bfloat16":
        x = jnp.asarray(RNG.random(n_el, dtype=np.float32), dtype=jnp.bfloat16)
    else:
        x = jnp.asarray(
            (RNG.random(n_el) * 100).astype(dtype)
            if np.dtype(dtype).kind == "f"
            else RNG.integers(0, 1000, n_el).astype(dtype)
        )
    tsz = x.dtype.itemsize
    nb = (n_el * tsz) // bs  # leaves a ragged word tail
    f8, t8 = tbdev._device_filter_prep(x, nb, bs, tsz, 1, False)
    fw, tw = tbdev._device_filter_prep(x, nb, bs, tsz, 1, True)
    assert np.asarray(fw).dtype != np.uint8  # the SWAR branch engaged
    assert (
        np.ascontiguousarray(np.asarray(fw)).tobytes()
        == np.asarray(f8).tobytes()
    )
    assert np.asarray(tw).tobytes() == np.asarray(t8).tobytes()


class TestDeviceDecodeStrategy:
    """strategy='device': host codec decode + on-device SWAR unfilter."""

    def _frame(self, data, shuffle=None, block=65536):
        from tpu_blosc.format import Shuffle

        opts = Options(
            type_size=data.dtype.itemsize,
            block_size=block,
            **({"shuffle": shuffle} if shuffle is not None else {}),
        )
        return blosc.compress_with_options(data.tobytes(), opts)

    @pytest.mark.parametrize("shuffle_name", ["shuffle", "bitshuffle"])
    def test_matches_transfer(self, shuffle_name):
        from tpu_blosc.format import Shuffle

        sh = (
            Shuffle.SHUFFLE if shuffle_name == "shuffle"
            else Shuffle.BITSHUFFLE
        )
        data = (np.arange(300_000) % 911).astype(np.float32)
        frame = self._frame(data, sh)
        got = tbdev.decompress_array(frame, np.float32, strategy="device")
        ref = tbdev.decompress_array(frame, np.float32, strategy="transfer")
        assert np.array_equal(np.asarray(got), np.asarray(ref))
        assert np.array_equal(np.asarray(got), data)

    def test_ragged_tail(self):
        data = (np.arange(70_003) % 257).astype(np.int32)
        frame = self._frame(data)
        got = tbdev.decompress_array(frame, np.int32, strategy="device")
        assert np.array_equal(np.asarray(got), data)

    def test_memcpy_blocks_pass_through_raw(self):
        rng = np.random.default_rng(7)
        # first half compressible, second half uniform-random u32 bytes —
        # incompressible even shuffled, so those blocks memcpy raw bytes
        data = np.concatenate([
            (np.arange(65536) % 100).astype(np.uint32),
            rng.integers(0, 2**32, 65536, dtype=np.uint32),
        ])
        frame = self._frame(data, block=32768)
        from tpu_blosc import chunk as _chunk
        from tpu_blosc.format import parse_header

        entries, _ = _chunk.parse_block_table(frame, parse_header(frame))
        assert any(m for _, m in entries)  # the fixture really mixes modes
        got = tbdev.decompress_array(frame, np.uint32, strategy="device")
        assert np.array_equal(np.asarray(got), data)

    def test_falls_back_for_ts2(self):
        data = (np.arange(200_000) % 300).astype(np.int16)
        frame = self._frame(data)
        got = tbdev.decompress_array(frame, np.int16, strategy="device")
        assert np.array_equal(np.asarray(got), data)

    def test_shape_and_sharding(self):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from tpu_blosc.dist.mesh import block_mesh

        data = (np.arange(2**18) % 512).astype(np.float32)
        frame = self._frame(data)
        mesh = block_mesh()
        sh = NamedSharding(mesh, P("blocks"))
        got = tbdev.decompress_array(
            frame, np.float32, shape=(512, 512), sharding=sh,
            strategy="device",
        )
        assert got.shape == (512, 512)
        assert np.array_equal(np.asarray(got).reshape(-1), data)


from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st


@settings(
    max_examples=25,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)
@given(
    n_el=st.integers(min_value=1, max_value=40_000),
    block_pow=st.integers(min_value=10, max_value=16),
    shuffle_bit=st.booleans(),
    codec_name=st.sampled_from(["lz4", "zstd"]),
    seed=st.integers(min_value=0, max_value=2**16),
)
def test_device_decode_strategy_differential(
    n_el, block_pow, shuffle_bit, codec_name, seed
):
    """Property: strategy='device' decodes ANY qualifying f32 frame to
    exactly the transfer-path bytes (and falls back silently otherwise)."""
    from tpu_blosc.format import Codec, Shuffle

    rng = np.random.default_rng(seed)
    data = (rng.random(n_el) * rng.integers(1, 1000)).astype(np.float32)
    opts = Options(
        type_size=4,
        block_size=1 << block_pow,
        shuffle=Shuffle.BITSHUFFLE if shuffle_bit else Shuffle.SHUFFLE,
        codec=Codec.ZSTD if codec_name == "zstd" else Codec.LZ4,
    )
    frame = blosc.compress_with_options(data.tobytes(), opts)
    got = tbdev.decompress_array(frame, np.float32, strategy="device")
    assert np.asarray(got).tobytes() == data.tobytes()


@settings(
    max_examples=40,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow],
)
@given(
    flip_pos=st.integers(min_value=0, max_value=4095),
    flip_val=st.integers(min_value=1, max_value=255),
    trunc=st.integers(min_value=0, max_value=200),
)
def test_device_decode_strategy_corrupt_frames_never_crash(
    flip_pos, flip_val, trunc
):
    """Corrupt/truncated frames through strategy='device' either raise a
    BloscError (like the host path) or decode identically to it — never
    crash, never silently return different bytes than the host decoder."""
    from tpu_blosc.errors import BloscError

    data = (np.arange(30_000) % 251).astype(np.float32)
    frame = bytearray(
        blosc.compress_with_options(
            data.tobytes(), Options(type_size=4, block_size=16384)
        )
    )
    if trunc:
        frame = frame[: max(0, len(frame) - trunc)]
    if frame and flip_pos < len(frame):
        frame[flip_pos] ^= flip_val
    frame = bytes(frame)
    try:
        ref = blosc.decompress(frame)
    except BloscError:
        ref = None
    try:
        got = tbdev.decompress_array(frame, np.float32, strategy="device")
        got_b = np.asarray(got).tobytes()
    except BloscError:
        got_b = None
    except TypeError:
        # size not a whole number of elements after corruption — the
        # documented decompress_array contract, host path may still work
        return
    if ref is None:
        assert got_b is None
    else:
        assert got_b == ref


def test_compress_array_bf16_bit_identical_to_host():
    x = jnp.asarray(np.arange(100_000) % 311, dtype=jnp.bfloat16)
    host_bytes = np.asarray(x).tobytes()
    opts = Options(type_size=2)
    frame_dev = tbdev.compress_array(x, opts)
    frame_host = blosc.compress_with_options(host_bytes, opts)
    assert frame_dev == frame_host
    assert blosc.decompress(frame_dev) == host_bytes
