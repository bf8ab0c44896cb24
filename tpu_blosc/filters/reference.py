"""NumPy reference implementation of the shuffle filters — the oracle.

These are the ground-truth semantics every accelerated path (the JAX/XLA
kernels in filters/jaxops.py and filters/batched.py, the native C++) must match
byte-for-byte, mirroring how the reference tests its SIMD kernels against a
duplicated generic implementation (reference: shuffle_amd64_test.go:152-174).

Semantics transcribed from the reference:

* byte shuffle  — full-array column transpose
  ``dst[j*num_elements + i] = src[i*type_size + j]``, the ``n % type_size``
  tail copied verbatim (shuffle.go:60-72); no-op when ``type_size <= 1`` or
  ``len(src) < type_size`` (shuffle.go:17-19).

* bit shuffle   — NON-standard local variant (shuffle.go:176-218): data is
  processed in groups of 8 elements; within a group, for each byte position
  ``byte_idx`` the 8 bytes at that position undergo an 8×8 bit transpose
  (output byte ``out_bit`` holds bit ``7-out_bit`` of every input byte,
  input byte ``in_byte`` contributing at bit ``7-in_byte``), written to
  ``dst[base + byte_idx*8 + out_bit]``.  Elements beyond the last full group
  of 8 and the ``n % type_size`` tail are copied UNtransposed.

In MSB-first unpacked-bit form the 8×8 transform is a plain transpose, which
is what the vectorized code below exploits (np.unpackbits/packbits are
MSB-first by default).
"""

from __future__ import annotations

import numpy as np


def _as_u8(src) -> np.ndarray:
    arr = np.frombuffer(src, dtype=np.uint8) if not isinstance(src, np.ndarray) else src
    if arr.dtype != np.uint8:
        arr = arr.view(np.uint8)
    return arr.reshape(-1)


def shuffle_bytes(src, type_size: int) -> np.ndarray:
    """Byte shuffle (≙ shuffleBytes, shuffle.go:16-73)."""
    a = _as_u8(src)
    n = a.size
    if type_size <= 1 or n < type_size:
        return a.copy()
    num_elements = n // type_size
    body = num_elements * type_size
    dst = np.empty(n, dtype=np.uint8)
    # dst[j*num_elements + i] = src[i*type_size + j]  ⇔  (ts, ne) = (ne, ts).T
    dst[:body] = a[:body].reshape(num_elements, type_size).T.reshape(-1)
    dst[body:] = a[body:]
    return dst


def unshuffle_bytes(src, type_size: int) -> np.ndarray:
    """Inverse byte shuffle (≙ unshuffleBytes, shuffle.go:76-133)."""
    a = _as_u8(src)
    n = a.size
    if type_size <= 1 or n < type_size:
        return a.copy()
    num_elements = n // type_size
    body = num_elements * type_size
    dst = np.empty(n, dtype=np.uint8)
    dst[:body] = a[:body].reshape(type_size, num_elements).T.reshape(-1)
    dst[body:] = a[body:]
    return dst


def bit_shuffle(src, type_size: int) -> np.ndarray:
    """Bit shuffle (≙ bitShuffle, shuffle.go:145-219) — local 8-element groups."""
    a = _as_u8(src)
    n = a.size
    if type_size <= 1 or n < type_size:
        return a.copy()
    num_elements = n // type_size
    num_groups = num_elements // 8
    grouped = num_groups * 8 * type_size
    dst = np.empty(n, dtype=np.uint8)
    if num_groups:
        # (G, 8 elems, ts) -> per byte position, 8x8 MSB-first bit transpose
        blk = a[:grouped].reshape(num_groups, 8, type_size)
        planes = np.ascontiguousarray(blk.transpose(0, 2, 1))  # (G, ts, 8)
        bits = np.unpackbits(planes, axis=-1).reshape(num_groups, type_size, 8, 8)
        out_bits = bits.transpose(0, 1, 3, 2).reshape(num_groups, type_size, 64)
        dst[:grouped] = np.packbits(
            np.ascontiguousarray(out_bits), axis=-1
        ).reshape(-1)
    # partial group of elements: copied untransposed (shuffle.go:204-210)
    dst[grouped:] = a[grouped:]
    return dst


def bit_unshuffle(src, type_size: int) -> np.ndarray:
    """Inverse bit shuffle (≙ bitUnshuffle, shuffle.go:222-295)."""
    a = _as_u8(src)
    n = a.size
    if type_size <= 1 or n < type_size:
        return a.copy()
    num_elements = n // type_size
    num_groups = num_elements // 8
    grouped = num_groups * 8 * type_size
    dst = np.empty(n, dtype=np.uint8)
    if num_groups:
        planes = a[:grouped].reshape(num_groups, type_size, 8)
        bits = np.unpackbits(planes, axis=-1).reshape(num_groups, type_size, 8, 8)
        orig = bits.transpose(0, 1, 3, 2).reshape(num_groups, type_size, 64)
        blk = np.packbits(np.ascontiguousarray(orig), axis=-1)  # (G, ts, 8)
        dst[:grouped] = np.ascontiguousarray(blk.transpose(0, 2, 1)).reshape(-1)
    dst[grouped:] = a[grouped:]
    return dst
