"""Card-only tests: the device path on an NVIDIA GPU.

Marked ``gpu``; the ``gpu_backend`` fixture skips them anywhere else.
``python chip_smoke.py`` runs them on the card (phase F).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc import device as tbdev
from tpu_blosc.filters import reference as ref
from tpu_blosc.format import Shuffle
from tpu_blosc.options import Options

pytestmark = pytest.mark.gpu

MiB = 1 << 20


@pytest.mark.parametrize("ts,dtype", [(2, jnp.bfloat16), (4, jnp.float32),
                                      (8, jnp.float64)])
@pytest.mark.parametrize("words", [True, False], ids=["swar", "u8"])
def test_filter_programs_match_reference_on_card(gpu_backend, ts, dtype,
                                                 words):
    nb, bs = 64, MiB
    raw = np.random.default_rng(ts).integers(0, 256, nb * bs, np.uint8)
    x = jax.device_put(raw.view(np.dtype(dtype)), gpu_backend)
    filtered, _ = tbdev._device_filter_prep(
        x, nb, bs, ts, int(Shuffle.SHUFFLE), words
    )
    got = np.asarray(filtered).view(np.uint8).reshape(nb, bs)
    for i in (0, nb // 2, nb - 1):
        want = ref.shuffle_bytes(raw[i * bs : (i + 1) * bs].tobytes(), ts)
        assert np.array_equal(got[i], want)
    back = tbdev._dev_unfilter_words(
        jax.device_put(got.view(np.uint32), gpu_backend),
        int(Shuffle.SHUFFLE), np.dtype(dtype).name,
    )
    assert np.asarray(back).view(np.uint8).tobytes() == raw.tobytes()


def test_results_stay_on_the_card(gpu_backend):
    x = jax.device_put(
        (np.arange(16 * MiB // 4) % 4099).astype(np.float32), gpu_backend
    )
    frame = blosc.compress_array(x, Options())
    for strategy in ("transfer", "device"):
        out = blosc.decompress_array(frame, np.float32, strategy=strategy)
        assert {d.platform for d in out.devices()} == {"gpu"}
        assert bool(jnp.array_equal(out, x))


def test_match_core_on_card_equals_cpu(gpu_backend):
    seg = 256 * 1024
    offs = tbdev._match_offsets(seg)
    base = (np.arange(16 * seg, dtype=np.uint32) % 251).astype(np.uint8)
    base = base.reshape(16, seg)
    on_card = tbdev._device_match_core(
        jax.device_put(base, gpu_backend), seg, offs
    )
    on_cpu = tbdev._device_match_core(
        jax.device_put(base, jax.devices("cpu")[0]), seg, offs
    )
    for a, b in zip(on_card, on_cpu):
        assert np.array_equal(np.asarray(a), np.asarray(b))
