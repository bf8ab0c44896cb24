"""JAX/XLA implementations of the shuffle filters (jit-compatible).

These are traced, statically-shaped functions over uint8 arrays — the
XLA-compiled analogue of the reference's generic Go loops (shuffle.go:60-72,
176-218), used on any backend; they must be byte-identical to
filters/reference.py (the oracle).

The batched kernels (filters/batched.py) build on these pieces; ragged
remainders (verbatim tails, partial groups) are host-side slicing in
filters/__init__.py, keeping traced shapes static.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# payload width for the two-stage byte-shuffle decomposition: transpose
# (P, ts) sub-tiles locally, then permute whole P-byte payloads, so the
# big (ne/P, ts) permute moves P-byte units instead of single bytes.  The
# inverse keeps the plain transpose — decomposing the gather direction
# only adds passes.
_SHUF_PAYLOAD = 8


def _bit_transpose_groups(planes: jax.Array) -> jax.Array:
    """8x8 MSB-first bit transpose over the last axis of a (..., 8) uint8 array.

    Returns (..., 8) uint8 where out[..., o] bit (7-i) = in[..., i] bit (7-o)
    — the exact per-group transform of the reference (shuffle.go:192-199).
    The transform is an involution, so it serves both directions.

    SWAR formulation: the 8 group bytes pack big-endian into two u32 words
    and three butterfly stages (Hacker's Delight transpose8, whose BE-in/
    BE-out semantics are exactly this MSB-first transform) do the whole
    8x8 in ~24 word ops — ~7 ops/byte vs 32 for an unrolled 64
    shift/or form.  The (..., 8, 8) bit-matrix form is an 8x blow-up of
    the data and is not used.
    """
    p = [planes[..., i].astype(jnp.uint32) for i in range(8)]
    x = (p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3]
    y = (p[4] << 24) | (p[5] << 16) | (p[6] << 8) | p[7]
    t = (x ^ (x >> 7)) & jnp.uint32(0x00AA00AA)
    x = x ^ t ^ (t << 7)
    t = (y ^ (y >> 7)) & jnp.uint32(0x00AA00AA)
    y = y ^ t ^ (t << 7)
    t = (x ^ (x >> 14)) & jnp.uint32(0x0000CCCC)
    x = x ^ t ^ (t << 14)
    t = (y ^ (y >> 14)) & jnp.uint32(0x0000CCCC)
    y = y ^ t ^ (t << 14)
    t = (x & jnp.uint32(0xF0F0F0F0)) | ((y >> 4) & jnp.uint32(0x0F0F0F0F))
    y = ((x << 4) & jnp.uint32(0xF0F0F0F0)) | (y & jnp.uint32(0x0F0F0F0F))
    x = t
    return jnp.stack(
        [
            (x >> 24).astype(jnp.uint8),
            (x >> 16).astype(jnp.uint8),
            (x >> 8).astype(jnp.uint8),
            x.astype(jnp.uint8),
            (y >> 24).astype(jnp.uint8),
            (y >> 16).astype(jnp.uint8),
            (y >> 8).astype(jnp.uint8),
            y.astype(jnp.uint8),
        ],
        axis=-1,
    )
