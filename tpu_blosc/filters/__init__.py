"""Filter dispatch: oracle-exact shuffle/bitshuffle with backend selection.

Dispatch contract mirrors the reference's SIMD probe-and-fallback
(shuffle.go:25-57, init at shuffle.go:3-5 / shuffle_amd64.go:12-14):

  * at import we probe the native C++ host kernels once (≙ useAVX2);
    the JAX device path is probed lazily, at the first call that could
    use it, so importing the package never starts an accelerator backend
    (which would reserve the card's memory in every importing process);
  * each call picks the fastest eligible path for its size, with the NumPy
    reference implementation as the always-correct generic fallback;
  * every path is byte-identical (tested against filters/reference.py).

Engagement thresholds (the analogue of the reference's documented SIMD
thresholds, shuffle.go:31-40, 156-158): device paths engage only above
_DEVICE_MIN_BYTES, below which host↔device transfer dominates.
"""

from __future__ import annotations

import os

import numpy as np

from ..format import Shuffle
from . import reference

_DEVICE_MIN_BYTES = int(os.environ.get("TPU_BLOSC_DEVICE_MIN_BYTES", 256 * 1024))

# None until decided: "native", "jax" or "numpy" (see backend_name)
_backend_name: str | None = None
_native = None


def _probe_native() -> None:
    """One-time host probe (≙ initSIMD, shuffle.go:3-5): the native C++
    kernels are the fastest path for host-resident buffers."""
    global _native
    if os.environ.get("TPU_BLOSC_FORCE_NUMPY"):
        return
    from ..native import backend as native

    if native.available():
        _native = native


_probe_native()


def _device_platform() -> str | None:
    """The JAX default backend's platform, or None when the device path
    is switched off (TPU_BLOSC_FORCE_NUMPY, TPU_BLOSC_NO_DEVICE) or JAX
    cannot start one.  Starts the backend: call only on a device path."""
    if os.environ.get("TPU_BLOSC_FORCE_NUMPY") or os.environ.get(
        "TPU_BLOSC_NO_DEVICE"
    ):
        return None
    try:
        import jax

        return jax.default_backend()
    except RuntimeError:  # JAX_PLATFORMS names a backend that cannot start
        return None


def backend_name() -> str:
    """Which accelerated path serves host buffers: 'native', 'jax' (an
    accelerator, when the native kernels are unavailable) or 'numpy'.
    Decided on first call; without the native kernels that call probes
    the JAX backend."""
    global _backend_name
    if _backend_name is None:
        if _native is not None:
            _backend_name = "native"
        else:
            platform = _device_platform()
            _backend_name = (
                "jax" if platform not in (None, "cpu") else "numpy"
            )
    return _backend_name


def device_eligible(n: int, type_size: int) -> bool:
    """Whether the device path engages for this host-call size."""
    return (
        n >= _DEVICE_MIN_BYTES
        and type_size > 1
        and n >= type_size
        and backend_name() == "jax"
    )


def _device_shuffle(a: np.ndarray, type_size: int, fn_name: str) -> np.ndarray:
    """Run the body on device, stitching the reference's verbatim tails.

    The body goes through the batched entries as a one-row batch — those
    route the SWAR word kernels (free host u32 views, 2-5x the
    byte-granular kernels for ts 2/4/8/16; filters/batched.py) and fall
    back to the u8 device kernels for unaligned geometries."""
    from . import batched as _batched

    n = a.size
    if fn_name in ("bit_shuffle", "bit_unshuffle"):
        group = 8 * type_size
        body = (n // group) * group
    else:
        body = (n // type_size) * type_size
    bfn = {
        "shuffle": _batched.shuffle_batch,
        "unshuffle": _batched.unshuffle_batch,
        "bit_shuffle": _batched.bit_shuffle_batch,
        "bit_unshuffle": _batched.bit_unshuffle_batch,
    }[fn_name]
    out = np.empty(n, dtype=np.uint8)
    if body:
        out[:body] = bfn(np.ascontiguousarray(a[:body]).reshape(1, body),
                         type_size)[0]
    # body covers all full elements/groups; tail copied verbatim
    out[body:] = a[body:]
    return out


def _dispatch(src, type_size: int, fn_name: str) -> np.ndarray:
    a = reference._as_u8(src)
    n = a.size
    if type_size <= 1 or n < type_size:
        return a.copy()
    # Host-resident buffers: the native SIMD path (20-40 GB/s in place)
    # always beats a host->device->host round trip, so the device path
    # engages only when native is unavailable.  Device-resident arrays use
    # filters.batched / dist.mesh directly and never hit this dispatch.
    if _native is None and device_eligible(n, type_size):
        try:
            return _device_shuffle(a, type_size, fn_name)
        except Exception:
            pass  # fall back to host paths (≙ usedSIMD=false path)
    if _native is not None:
        nat_fn = {
            "shuffle": _native.shuffle,
            "unshuffle": _native.unshuffle,
            "bit_shuffle": _native.bitshuffle,
            "bit_unshuffle": _native.bitunshuffle,
        }[fn_name]
        try:
            return nat_fn(a, type_size)
        except Exception:
            pass
    ref_fn = {
        "shuffle": reference.shuffle_bytes,
        "unshuffle": reference.unshuffle_bytes,
        "bit_shuffle": reference.bit_shuffle,
        "bit_unshuffle": reference.bit_unshuffle,
    }[fn_name]
    return ref_fn(a, type_size)


def shuffle_bytes(src, type_size: int) -> np.ndarray:
    return _dispatch(src, type_size, "shuffle")


def unshuffle_bytes(src, type_size: int) -> np.ndarray:
    return _dispatch(src, type_size, "unshuffle")


def bit_shuffle(src, type_size: int) -> np.ndarray:
    return _dispatch(src, type_size, "bit_shuffle")


def bit_unshuffle(src, type_size: int) -> np.ndarray:
    return _dispatch(src, type_size, "bit_unshuffle")


def apply_filter(src, type_size: int, mode: Shuffle) -> np.ndarray:
    if mode == Shuffle.SHUFFLE:
        return shuffle_bytes(src, type_size)
    if mode == Shuffle.BITSHUFFLE:
        return bit_shuffle(src, type_size)
    return reference._as_u8(src).copy()


def remove_filter(src, type_size: int, mode: Shuffle) -> np.ndarray:
    if mode == Shuffle.SHUFFLE:
        return unshuffle_bytes(src, type_size)
    if mode == Shuffle.BITSHUFFLE:
        return bit_unshuffle(src, type_size)
    return reference._as_u8(src).copy()


def shuffle_buffer(data: bytearray | np.ndarray, type_size: int, mode: Shuffle) -> None:
    """In-place shuffle (≙ ShuffleBuffer, shuffle.go:298-309)."""
    if mode not in (Shuffle.SHUFFLE, Shuffle.BITSHUFFLE):
        return
    result = apply_filter(bytes(data), type_size, mode)
    data[:] = result.tobytes() if isinstance(data, bytearray) else result


def unshuffle_buffer(data: bytearray | np.ndarray, type_size: int, mode: Shuffle) -> None:
    """In-place unshuffle (≙ UnshuffleBuffer, shuffle.go:312-323)."""
    if mode not in (Shuffle.SHUFFLE, Shuffle.BITSHUFFLE):
        return
    result = remove_filter(bytes(data), type_size, mode)
    data[:] = result.tobytes() if isinstance(data, bytearray) else result
