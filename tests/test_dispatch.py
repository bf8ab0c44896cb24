"""Dispatch engagement-threshold tests (≙ shuffle_amd64_test.go:20-34).

The reference asserts exactly when its SIMD kernels engage vs return false
(typeSize==4 && n>=32 && >=8 elements for AVX2 byteshuffle, etc.).  Our
analogue: the device path engages only above _DEVICE_MIN_BYTES with a
usable type size, and every backend choice degrades to the numpy oracle.
"""

import numpy as np
import pytest

from tpu_blosc import filters
from tpu_blosc.filters import reference as ref


@pytest.fixture
def force_device_backend(monkeypatch):
    """Pretend a device backend is active to test the threshold table."""
    monkeypatch.setattr(filters, "_backend_name", "jax")
    yield


ENGAGEMENT_TABLE = [
    # (n, type_size, expected)
    (0, 4, False),
    (filters._DEVICE_MIN_BYTES - 1, 4, False),   # below threshold
    (filters._DEVICE_MIN_BYTES, 4, True),        # at threshold
    (filters._DEVICE_MIN_BYTES, 1, False),       # ts<=1 never engages
    (filters._DEVICE_MIN_BYTES, 0, False),
    (4 * filters._DEVICE_MIN_BYTES, 8, True),
]


@pytest.mark.parametrize("n,ts,expected", ENGAGEMENT_TABLE)
def test_device_engagement_table(force_device_backend, n, ts, expected):
    assert filters.device_eligible(n, ts) is expected


def test_native_backend_never_uses_device_path():
    # on the CPU test mesh the probe selects native/numpy; device path off
    assert filters.backend_name() in ("native", "numpy")
    assert not filters.device_eligible(10**8, 4)


def test_forced_numpy_env(monkeypatch):
    """TPU_BLOSC_FORCE_NUMPY short-circuits the probe (≙ generic build tag)."""
    import importlib
    import os

    monkeypatch.setenv("TPU_BLOSC_FORCE_NUMPY", "1")
    import tpu_blosc.filters as f

    importlib.reload(f)
    try:
        assert f.backend_name() == "numpy"
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        assert np.array_equal(f.shuffle_bytes(data, 4), ref.shuffle_bytes(data, 4))
    finally:
        monkeypatch.delenv("TPU_BLOSC_FORCE_NUMPY")
        importlib.reload(f)


def test_no_device_env(monkeypatch):
    """TPU_BLOSC_NO_DEVICE skips only the jax/device probe: the native
    host path stays, and the device path never engages."""
    import importlib

    monkeypatch.setenv("TPU_BLOSC_NO_DEVICE", "1")
    import tpu_blosc.filters as f

    importlib.reload(f)
    try:
        assert f.backend_name() in ("native", "numpy")
        assert not f.device_eligible(10**8, 4)
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        assert np.array_equal(f.shuffle_bytes(data, 4), ref.shuffle_bytes(data, 4))
    finally:
        monkeypatch.delenv("TPU_BLOSC_NO_DEVICE")
        importlib.reload(f)


def test_all_backends_byte_identical():
    """Whatever path dispatch picks, output equals the oracle byte-for-byte
    (the core contract; reference shuffle.go:31-57)."""
    rng = np.random.default_rng(11)
    for n in (64, 1003, 65536, filters._DEVICE_MIN_BYTES + 17):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for ts in (2, 4, 8, 16):
            assert np.array_equal(
                filters.shuffle_bytes(data, ts), ref.shuffle_bytes(data, ts)
            )
            assert np.array_equal(
                filters.bit_shuffle(data, ts), ref.bit_shuffle(data, ts)
            )


def test_import_starts_no_backend():
    """Importing the package (and using its host paths) must not start a
    JAX backend: on a GPU that would reserve most of the card's memory
    in every importing process (CLI, checkpoint workers)."""
    import subprocess
    import sys

    code = (
        "import numpy as np\n"
        "import tpu_blosc as b, tpu_blosc.checkpoint, tpu_blosc.dist\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge.backends_are_initialized()\n"
        "d = np.arange(3 << 20, dtype=np.float32).tobytes()\n"
        "assert b.decompress(b.compress_with_options(d, b.Options())) == d\n"
        "b.backend_name()\n"
        "assert not xla_bridge.backends_are_initialized(), 'host path'\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
