"""The device filter programs (plain XLA) against the NumPy oracle.

Byte shuffle of ts=2/4 runs as XLA word (SWAR) kernels on the compress
side (device._device_filter_prep) and on the 'device' decode side
(device._dev_unfilter_words); the u8 reshape-transpose kernels are the
byte-granular alternative.  Every formulation must equal
filters/reference.py block by block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc import device as tbdev
from tpu_blosc.filters import batched as fb
from tpu_blosc.filters import reference as ref
from tpu_blosc.format import Shuffle
from tpu_blosc.options import Options

DTYPES = {2: jnp.bfloat16, 4: jnp.float32, 8: jnp.float64}
SHAPES = [(1, 4096), (2, 16384), (3, 65536), (4, 1 << 18)]


def _raw(nb: int, bs: int, extra: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, nb * bs + extra, dtype=np.uint8)


def _blocks_shuffled(raw: np.ndarray, nb: int, bs: int, ts: int) -> np.ndarray:
    return np.stack(
        [ref.shuffle_bytes(raw[i * bs : (i + 1) * bs].tobytes(), ts)
         for i in range(nb)]
    )


@pytest.mark.parametrize("ts", [2, 4])
@pytest.mark.parametrize("nb,bs", SHAPES)
@pytest.mark.parametrize("words", [True, False], ids=["swar", "u8"])
def test_device_shuffle_matches_reference(ts, nb, bs, words):
    raw = _raw(nb, bs, 2 * ts, seed=nb * bs + ts)  # + a ragged tail
    x = jax.lax.bitcast_convert_type(
        jnp.asarray(raw.view(np.uint16 if ts == 2 else np.uint32)),
        DTYPES[ts],
    )
    filtered, tail = tbdev._device_filter_prep(
        x, nb, bs, ts, int(Shuffle.SHUFFLE), words
    )
    got = np.asarray(filtered).view(np.uint8).reshape(nb, bs)
    assert np.array_equal(got, _blocks_shuffled(raw, nb, bs, ts))
    assert np.asarray(tail).tobytes() == raw[nb * bs :].tobytes()


@pytest.mark.parametrize("ts", [2, 4])
@pytest.mark.parametrize("nb,bs", SHAPES)
@pytest.mark.parametrize("words", [True, False], ids=["swar", "u8"])
def test_device_unshuffle_matches_reference(ts, nb, bs, words):
    raw = _raw(nb, bs, 0, seed=7 * nb + bs + ts)
    shuffled = _blocks_shuffled(raw, nb, bs, ts)
    if words:
        dt = np.dtype(DTYPES[ts])
        out = tbdev._dev_unfilter_words(
            jnp.asarray(shuffled.view(np.uint32)), int(Shuffle.SHUFFLE),
            dt.name,
        )
        assert out.dtype == dt and out.shape == (nb * bs // ts,)
        got = np.asarray(out).view(np.uint8)
    else:
        got = np.asarray(fb._unshuffle_batch_dev(jnp.asarray(shuffled), ts))
    assert np.array_equal(got.reshape(-1), raw)


@pytest.mark.parametrize(
    "dtype", [jnp.bfloat16, np.float16, np.int16, np.float32, np.float64]
)
@pytest.mark.parametrize("mode", [Shuffle.SHUFFLE, Shuffle.BITSHUFFLE])
def test_device_decode_strategy_engages(dtype, mode):
    """strategy='device' unfilters on device for every type size with a
    word kernel (2, 4, 8), equals the source, and does not fall back."""
    dt = np.dtype(dtype)
    vals = (np.arange(150_001) % 977).astype(np.float32)
    data = vals.astype(dt)
    frame = blosc.compress_with_options(
        data.tobytes(),
        Options(type_size=dt.itemsize, block_size=65536, shuffle=mode),
    )
    real = tbdev._decompress_array_devfilter
    seen = []

    def spy(*a, **k):
        r = real(*a, **k)
        seen.append(r is not None)
        return r

    tbdev._decompress_array_devfilter = spy
    try:
        got = blosc.decompress_array(frame, dt, strategy="device")
    finally:
        tbdev._decompress_array_devfilter = real
    assert seen == [True]
    assert got.dtype == dt
    assert np.asarray(got).tobytes() == data.tobytes()
