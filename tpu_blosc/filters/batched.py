"""Batched device filters: shuffle a whole batch of equal-size blocks at once.

One jit-compiled call filters (nb, block_size) uint8 on the accelerator —
the device analogue of the reference looping its SIMD kernel over a buffer
(shuffle_amd64.s:183-226), except the batch dimension also maps 1:1 onto a
device mesh axis for multi-chip sharding (dist/mesh.py shard_maps these
exact functions).

All functions take/return host numpy arrays of shape (nb, bs) with bs a
multiple of type_size (bit variants: of 8*type_size); ragged tails never
reach this layer (chunk.py keeps the final short block on the host path).

Performance note: byte-granular relayouts are what costs.  The SWAR word
kernels (`_SWAR_SHUFFLE`/`_SWAR_BIT_SHUFFLE` tables) therefore run the
whole transform in u32 registers as elementwise word ops.  On an H100
(1 GiB, ts=2 and ts=4, both directions) they run as fast as a device
copy of the same bytes, while the u8 reshape-transpose kernels reach
about two thirds of it (PERF.md).  The word views are free from host
buffers (np .view) and from same-width device dtypes (bitcast);
bitcasting a device u8 array to words is itself a relayout and loses
the gain.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import jaxops


@partial(jax.jit, static_argnums=(1,))
def _shuffle_batch_dev(x: jax.Array, type_size: int) -> jax.Array:
    nb, bs = x.shape
    ne = bs // type_size
    P = jaxops._SHUF_PAYLOAD
    if ne % P == 0:
        # two-stage: local (P, ts) sub-tile transpose, then a whole-payload
        # permute — see jaxops._SHUF_PAYLOAD for the measured rationale
        t = x.reshape(nb, ne // P, P, type_size)
        return jnp.swapaxes(t, 2, 3).swapaxes(1, 2).reshape(nb, bs)
    return jnp.swapaxes(x.reshape(nb, ne, type_size), 1, 2).reshape(nb, bs)


@partial(jax.jit, static_argnums=(1,))
def _unshuffle_batch_dev(x: jax.Array, type_size: int) -> jax.Array:
    # plain transpose: the inverse direction gains nothing from the
    # payload sub-tiling (see jaxops._SHUF_PAYLOAD note)
    nb, bs = x.shape
    ne = bs // type_size
    return jnp.swapaxes(x.reshape(nb, type_size, ne), 1, 2).reshape(nb, bs)


@partial(jax.jit, static_argnums=(1,))
def _bit_shuffle_batch_dev(x: jax.Array, type_size: int) -> jax.Array:
    nb, bs = x.shape
    g = bs // (8 * type_size)
    blk = x.reshape(nb, g, 8, type_size)
    planes = jnp.swapaxes(blk, 2, 3)  # (nb, g, ts, 8)
    return jaxops._bit_transpose_groups(planes).reshape(nb, bs)


@partial(jax.jit, static_argnums=(1,))
def _bit_unshuffle_batch_dev(x: jax.Array, type_size: int) -> jax.Array:
    nb, bs = x.shape
    g = bs // (8 * type_size)
    planes = x.reshape(nb, g, type_size, 8)
    blk = jaxops._bit_transpose_groups(planes)  # (nb, g, ts, 8)
    return jnp.swapaxes(blk, 2, 3).reshape(nb, bs)


def _t4x4(a, b, c, d):
    """Byte transpose of a 4x4 block held in 4 LE u32 words: o_k carries
    byte k of a,b,c,d (packed LE).  ~20 word ops per 16 bytes — the whole
    ts=4 shuffle runs in u32 space with no byte-granular relayout."""
    m0 = jnp.uint32(0x00FF00FF)
    m1 = jnp.uint32(0xFF00FF00)
    x0 = (a & m0) | ((b & m0) << 8)
    x1 = ((a >> 8) & m0) | (b & m1)
    x2 = (c & m0) | ((d & m0) << 8)
    x3 = ((c >> 8) & m0) | (d & m1)
    lo = jnp.uint32(0x0000FFFF)
    hi = jnp.uint32(0xFFFF0000)
    o0 = (x0 & lo) | (x2 << 16)
    o2 = (x0 >> 16) | (x2 & hi)
    o1 = (x1 & lo) | (x3 << 16)
    o3 = (x1 >> 16) | (x3 & hi)
    return o0, o1, o2, o3


@jax.jit
def _shuffle_batch_dev_u32(xw: jax.Array) -> jax.Array:
    """ts=4 byte shuffle over (nb, bs//4) uint32 rows (bs % 16 == 0).

    The words ARE the elements, so the (ne, 4) byte transpose becomes a
    4x4 SWAR transpose per word quad + a coarse concat, with no
    byte-granular relayout.  Input must arrive as u32 (free host .view /
    free same-width bitcast from 4-byte dtypes); converting a device u8
    array costs more than it saves.
    """
    nb, ne = xw.shape
    q = xw.reshape(nb, ne // 4, 4)
    o0, o1, o2, o3 = _t4x4(q[..., 0], q[..., 1], q[..., 2], q[..., 3])
    return jnp.concatenate([o0, o1, o2, o3], axis=1)


@jax.jit
def _unshuffle_batch_dev_u32(xw: jax.Array) -> jax.Array:
    """Inverse of _shuffle_batch_dev_u32."""
    nb, ne = xw.shape
    q = xw.reshape(nb, 4, ne // 4)
    o0, o1, o2, o3 = _t4x4(q[:, 0], q[:, 1], q[:, 2], q[:, 3])
    return jnp.stack([o0, o1, o2, o3], axis=-1).reshape(nb, ne)


def _ts2_plane_pair(wa, wb, shift):
    """Pack byte (shift/8) of the 4 ts=2 elements held in words wa, wb
    (2 elements per u32 word) into one plane word."""
    t0 = (wa >> shift) & jnp.uint32(0x00FF00FF)
    t1 = (wb >> shift) & jnp.uint32(0x00FF00FF)
    lo = (t0 | (t0 >> 8)) & jnp.uint32(0x0000FFFF)
    hi = (t1 | (t1 >> 8)) & jnp.uint32(0x0000FFFF)
    return lo | (hi << 16)


def _ts2_weave(x, y):
    """Inverse of _ts2_plane_pair over 4 elements: x = their b0 bytes,
    y = their b1 bytes; returns the 2 element words."""
    mlo, mhi = jnp.uint32(0xFF), jnp.uint32(0xFF00)
    w0 = (x & mlo) | ((y & mlo) << 8) | ((x & mhi) << 8) | ((y & mhi) << 16)
    xh, yh = x >> 16, y >> 16
    w1 = (
        (xh & mlo) | ((yh & mlo) << 8) | ((xh & mhi) << 8)
        | ((yh & mhi) << 16)
    )
    return w0, w1


@jax.jit
def _shuffle_batch_dev_u32_ts2(xw: jax.Array) -> jax.Array:
    """ts=2 byte shuffle over (nb, bs//4) uint32 rows (bs % 8 == 0).

    The bf16/f16/int16 SWAR path for host word views.  Runs in u32 (2
    elements per word) rather than u16-per-element: half as many word
    ops for the same bytes."""
    nb, ne = xw.shape
    q = xw.reshape(nb, ne // 2, 2)
    o0 = _ts2_plane_pair(q[..., 0], q[..., 1], 0)
    o1 = _ts2_plane_pair(q[..., 0], q[..., 1], 8)
    return jnp.concatenate([o0, o1], axis=1)


@jax.jit
def _unshuffle_batch_dev_u32_ts2(xw: jax.Array) -> jax.Array:
    """Inverse of _shuffle_batch_dev_u32_ts2 (see its docstring)."""
    nb, ne = xw.shape
    q = xw.reshape(nb, 2, ne // 2)
    w0, w1 = _ts2_weave(q[:, 0], q[:, 1])
    return jnp.stack([w0, w1], axis=-1).reshape(nb, ne)


@jax.jit
def _shuffle_batch_dev_u16(xh: jax.Array) -> jax.Array:
    """ts=2 byte shuffle over (nb, bs//2) uint16 rows (bs % 4 == 0) —
    the same-width-bitcast variant for device u16/bf16 arrays, where
    widening to u32 would itself be a relayout."""
    nb, ne = xh.shape
    q = xh.reshape(nb, ne // 2, 2)
    a, b = q[..., 0], q[..., 1]
    m = jnp.uint16(0x00FF)
    o0 = (a & m) | ((b & m) << 8)
    o1 = ((a >> 8) & m) | (b & jnp.uint16(0xFF00))
    return jnp.concatenate([o0, o1], axis=1)


@jax.jit
def _unshuffle_batch_dev_u16(xh: jax.Array) -> jax.Array:
    """Inverse of _shuffle_batch_dev_u16."""
    nb, ne = xh.shape
    q = xh.reshape(nb, 2, ne // 2)
    a, b = q[:, 0], q[:, 1]
    m = jnp.uint16(0x00FF)
    e0 = (a & m) | ((b & m) << 8)
    e1 = ((a >> 8) & m) | (b & jnp.uint16(0xFF00))
    return jnp.stack([e0, e1], axis=-1).reshape(nb, ne)


@jax.jit
def _shuffle_batch_dev_u32_ts8(xw: jax.Array) -> jax.Array:
    """ts=8 byte shuffle over (nb, bs//4) uint32 rows (bs % 32 == 0).

    An 8-byte element is two adjacent LE u32 words; planes 0-3 come from
    the even (lo) words, planes 4-7 from the odd (hi) words — two 4x4
    SWAR transposes over word picks from each octet."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 8, 8)
    o0, o1, o2, o3 = _t4x4(r[..., 0], r[..., 2], r[..., 4], r[..., 6])
    o4, o5, o6, o7 = _t4x4(r[..., 1], r[..., 3], r[..., 5], r[..., 7])
    return jnp.concatenate([o0, o1, o2, o3, o4, o5, o6, o7], axis=1)


@jax.jit
def _unshuffle_batch_dev_u32_ts8(xw: jax.Array) -> jax.Array:
    """Inverse of _shuffle_batch_dev_u32_ts8.

    One flat 8-array interleave (l_i = lo word of element 4j+i, h_i its
    hi word) rather than a staged stack-4+reshape+stack-2."""
    nb, ne = xw.shape
    q = xw.reshape(nb, 8, ne // 8)
    l0, l1, l2, l3 = _t4x4(q[:, 0], q[:, 1], q[:, 2], q[:, 3])
    h0, h1, h2, h3 = _t4x4(q[:, 4], q[:, 5], q[:, 6], q[:, 7])
    return jnp.stack(
        [l0, h0, l1, h1, l2, h2, l3, h3], axis=-1
    ).reshape(nb, ne)


def _bit_t8x8_words(x, y):
    """8x8 MSB-first bit transpose over 8 plane bytes held in two LE u32
    words (x = bytes 0-3, y = bytes 4-7 of the plane) — the same
    transform as jaxops._bit_transpose_groups, staying in word registers.

    This is Hacker's Delight transpose8 conjugated by byte reversal so it
    applies to LE-packed words directly: the bit-pair exchanges at BE
    distances 7/14 land at LE distances 9/18 with the lower-member masks
    0x00550055/0x00003333 (verified equal to the bswap-wrapped BE form);
    the cross-word nibble stage is per-byte and R-invariant.  Saves 8
    byteswaps (~32 word ops) per 8 bytes vs wrapping the BE kernel."""
    t = (x ^ (x >> 9)) & jnp.uint32(0x00550055)
    x = x ^ t ^ (t << 9)
    t = (y ^ (y >> 9)) & jnp.uint32(0x00550055)
    y = y ^ t ^ (t << 9)
    t = (x ^ (x >> 18)) & jnp.uint32(0x00003333)
    x = x ^ t ^ (t << 18)
    t = (y ^ (y >> 18)) & jnp.uint32(0x00003333)
    y = y ^ t ^ (t << 18)
    t = (x & jnp.uint32(0xF0F0F0F0)) | ((y >> 4) & jnp.uint32(0x0F0F0F0F))
    y = ((x << 4) & jnp.uint32(0xF0F0F0F0)) | (y & jnp.uint32(0x0F0F0F0F))
    return t, y


@jax.jit
def _bit_shuffle_batch_dev_u32(xw: jax.Array) -> jax.Array:
    """ts=4 bitshuffle over (nb, bs//4) uint32 rows (bs % 32 == 0).

    A group is 8 consecutive elements = 8 words.  Byte-plane regroup is
    two 4x4 SWAR transposes (plane k -> words a_k: bytes k of e0..e3,
    b_k: of e4..e7); each plane's 8 bytes then bit-transpose in-register
    (_bit_t8x8_words); output interleave [a0 b0 a1 b1 ...] is the only
    relayout and it is word-granular."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 8, 8)
    a0, a1, a2, a3 = _t4x4(r[..., 0], r[..., 1], r[..., 2], r[..., 3])
    b0, b1, b2, b3 = _t4x4(r[..., 4], r[..., 5], r[..., 6], r[..., 7])
    outs = []
    for ak, bk in ((a0, b0), (a1, b1), (a2, b2), (a3, b3)):
        outs.extend(_bit_t8x8_words(ak, bk))
    return jnp.stack(outs, axis=-1).reshape(nb, ne)


@jax.jit
def _bit_unshuffle_batch_dev_u32(xw: jax.Array) -> jax.Array:
    """Inverse of _bit_shuffle_batch_dev_u32."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 8, 8)
    planes = [
        _bit_t8x8_words(r[..., 2 * k], r[..., 2 * k + 1]) for k in range(4)
    ]
    e0, e1, e2, e3 = _t4x4(*(p[0] for p in planes))
    e4, e5, e6, e7 = _t4x4(*(p[1] for p in planes))
    return jnp.stack([e0, e1, e2, e3, e4, e5, e6, e7], axis=-1).reshape(
        nb, ne
    )


@jax.jit
def _bit_shuffle_batch_dev_u32_ts2(xw: jax.Array) -> jax.Array:
    """ts=2 bitshuffle over (nb, bs//4) uint32 rows (bs % 16 == 0).

    A group is 8 consecutive 2-byte elements = 4 words (2 elements per
    word).  Byte planes extract via mask-and-pack (b0s sit at bytes 0,2
    of each word), bit-transpose in-register, word-granular interleave."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 4, 4)
    # plane0: byte0 of e0..e3 from words 0-1, of e4..e7 from words 2-3
    # (the same plane packing as the ts=2 byte shuffle)
    a0 = _ts2_plane_pair(r[..., 0], r[..., 1], 0)
    b0 = _ts2_plane_pair(r[..., 2], r[..., 3], 0)
    a1 = _ts2_plane_pair(r[..., 0], r[..., 1], 8)
    b1 = _ts2_plane_pair(r[..., 2], r[..., 3], 8)
    t = [*_bit_t8x8_words(a0, b0), *_bit_t8x8_words(a1, b1)]
    return jnp.stack(t, axis=-1).reshape(nb, ne)


@jax.jit
def _bit_unshuffle_batch_dev_u32_ts2(xw: jax.Array) -> jax.Array:
    """Inverse of _bit_shuffle_batch_dev_u32_ts2."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 4, 4)
    a0, b0 = _bit_t8x8_words(r[..., 0], r[..., 1])
    a1, b1 = _bit_t8x8_words(r[..., 2], r[..., 3])
    w0, w1 = _ts2_weave(a0, a1)  # same byte interleave as the byte path
    w2, w3 = _ts2_weave(b0, b1)
    return jnp.stack([w0, w1, w2, w3], axis=-1).reshape(nb, ne)


@jax.jit
def _bit_shuffle_batch_dev_u32_ts8(xw: jax.Array) -> jax.Array:
    """ts=8 bitshuffle over (nb, bs//4) uint32 rows (bs % 64 == 0).

    A group is 8 consecutive 8-byte elements = 16 words (element = lo,hi
    word pair).  Planes 0-3 come from the lo words, 4-7 from the hi
    words, each via 4x4 SWAR; then per-plane in-register bit transpose."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 16, 16)
    outs = []
    for half in (0, 1):  # lo words -> planes 0-3, hi words -> planes 4-7
        a = _t4x4(r[..., half], r[..., 2 + half], r[..., 4 + half],
                  r[..., 6 + half])
        b = _t4x4(r[..., 8 + half], r[..., 10 + half], r[..., 12 + half],
                  r[..., 14 + half])
        for k in range(4):
            outs.extend(_bit_t8x8_words(a[k], b[k]))
    return jnp.stack(outs, axis=-1).reshape(nb, ne)


@jax.jit
def _bit_unshuffle_batch_dev_u32_ts8(xw: jax.Array) -> jax.Array:
    """Inverse of _bit_shuffle_batch_dev_u32_ts8."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 16, 16)
    planes = [
        _bit_t8x8_words(r[..., 2 * k], r[..., 2 * k + 1]) for k in range(8)
    ]
    lo_a = _t4x4(*(planes[k][0] for k in range(4)))   # lo words of e0..e3
    lo_b = _t4x4(*(planes[k][1] for k in range(4)))   # lo words of e4..e7
    hi_a = _t4x4(*(planes[4 + k][0] for k in range(4)))
    hi_b = _t4x4(*(planes[4 + k][1] for k in range(4)))
    words = []
    for part_lo, part_hi in ((lo_a, hi_a), (lo_b, hi_b)):
        for i in range(4):
            words.extend((part_lo[i], part_hi[i]))
    return jnp.stack(words, axis=-1).reshape(nb, ne)


#: byte-shuffle SWAR block-size quantum per type_size (u32 words)
_SWAR_QUANTA = {2: 8, 4: 16, 8: 32, 16: 64}


def _word_view(arr: np.ndarray, type_size: int) -> np.ndarray | None:
    """Free reinterpretation of (nb, bs) u8 rows as byte-shuffle SWAR
    u32 words, when alignment/shape allow."""
    return _view_as(arr, np.uint32, _SWAR_QUANTA[type_size])


def _view_as(arr: np.ndarray, wdt, quant: int) -> np.ndarray | None:
    if arr.shape[1] % quant:
        return None
    try:
        return arr.view(wdt)
    except ValueError:  # non-contiguous / misaligned source
        return None


@jax.jit
def _shuffle_batch_dev_u32_ts16(xw: jax.Array) -> jax.Array:
    """ts=16 byte shuffle over (nb, bs//4) uint32 rows (bs % 64 == 0).

    A group is 4 consecutive 16-byte elements = 16 words; byte plane
    k = 4w+b comes from one 4x4 SWAR over word w of the 4 elements
    (≙ the reference's SSE ts16 kernel, shuffle_amd64.s, word-SWAR form)."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 16, 16)
    outs = []
    for w in range(4):
        outs.extend(_t4x4(r[..., w], r[..., 4 + w], r[..., 8 + w],
                          r[..., 12 + w]))
    return jnp.concatenate(outs, axis=1)


@jax.jit
def _unshuffle_batch_dev_u32_ts16(xw: jax.Array) -> jax.Array:
    """Inverse of _shuffle_batch_dev_u32_ts16."""
    nb, ne = xw.shape
    q = xw.reshape(nb, 16, ne // 16)
    t = [
        _t4x4(q[:, 4 * w], q[:, 4 * w + 1], q[:, 4 * w + 2], q[:, 4 * w + 3])
        for w in range(4)
    ]
    words = [t[w][i] for i in range(4) for w in range(4)]
    return jnp.stack(words, axis=-1).reshape(nb, ne)


@jax.jit
def _bit_shuffle_batch_dev_u32_ts16(xw: jax.Array) -> jax.Array:
    """ts=16 bitshuffle over (nb, bs//4) uint32 rows (bs % 128 == 0)."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 32, 32)
    outs = []
    for w in range(4):
        a = _t4x4(r[..., w], r[..., 4 + w], r[..., 8 + w], r[..., 12 + w])
        b = _t4x4(r[..., 16 + w], r[..., 20 + w], r[..., 24 + w],
                  r[..., 28 + w])
        for k in range(4):
            outs.extend(_bit_t8x8_words(a[k], b[k]))
    return jnp.stack(outs, axis=-1).reshape(nb, ne)


@jax.jit
def _bit_unshuffle_batch_dev_u32_ts16(xw: jax.Array) -> jax.Array:
    """Inverse of _bit_shuffle_batch_dev_u32_ts16."""
    nb, ne = xw.shape
    r = xw.reshape(nb, ne // 32, 32)
    planes = [
        _bit_t8x8_words(r[..., 2 * p], r[..., 2 * p + 1]) for p in range(16)
    ]
    ta = [
        _t4x4(*(planes[4 * w + b][0] for b in range(4))) for w in range(4)
    ]
    tb = [
        _t4x4(*(planes[4 * w + b][1] for b in range(4))) for w in range(4)
    ]
    words = [ta[w][i] for i in range(4) for w in range(4)] + [
        tb[w][i] for i in range(4) for w in range(4)
    ]
    return jnp.stack(words, axis=-1).reshape(nb, ne)


_SWAR_BIT_SHUFFLE = {
    2: (_bit_shuffle_batch_dev_u32_ts2, 16),
    4: (_bit_shuffle_batch_dev_u32, 32),
    8: (_bit_shuffle_batch_dev_u32_ts8, 64),
    16: (_bit_shuffle_batch_dev_u32_ts16, 128),
}
_SWAR_BIT_UNSHUFFLE = {
    2: (_bit_unshuffle_batch_dev_u32_ts2, 16),
    4: (_bit_unshuffle_batch_dev_u32, 32),
    8: (_bit_unshuffle_batch_dev_u32_ts8, 64),
    16: (_bit_unshuffle_batch_dev_u32_ts16, 128),
}


#: host-view SWAR byte-shuffle kernels — all take (nb, bs//4) u32 rows
_SWAR_SHUFFLE = {
    2: _shuffle_batch_dev_u32_ts2,
    4: _shuffle_batch_dev_u32,
    8: _shuffle_batch_dev_u32_ts8,
    16: _shuffle_batch_dev_u32_ts16,
}
_SWAR_UNSHUFFLE = {
    2: _unshuffle_batch_dev_u32_ts2,
    4: _unshuffle_batch_dev_u32,
    8: _unshuffle_batch_dev_u32_ts8,
    16: _unshuffle_batch_dev_u32_ts16,
}


def _run(fn, arr: np.ndarray, type_size: int) -> np.ndarray:
    out = fn(jnp.asarray(arr), type_size)
    return np.asarray(out)


def shuffle_batch(arr: np.ndarray, type_size: int) -> np.ndarray:
    """Byte-shuffle each row of (nb, bs); bs must be a multiple of ts."""
    if arr.shape[1] % type_size:
        raise ValueError("block size must be a multiple of type_size")
    if type_size in _SWAR_SHUFFLE:
        w = _word_view(arr, type_size)
        if w is not None:
            out = np.asarray(_SWAR_SHUFFLE[type_size](jnp.asarray(w)))
            return out.view(np.uint8)
    return _run(_shuffle_batch_dev, arr, type_size)


def unshuffle_batch(arr: np.ndarray, type_size: int) -> np.ndarray:
    if arr.shape[1] % type_size:
        raise ValueError("block size must be a multiple of type_size")
    if type_size in _SWAR_UNSHUFFLE:
        w = _word_view(arr, type_size)
        if w is not None:
            out = np.asarray(_SWAR_UNSHUFFLE[type_size](jnp.asarray(w)))
            return out.view(np.uint8)
    return _run(_unshuffle_batch_dev, arr, type_size)


def bit_shuffle_batch(arr: np.ndarray, type_size: int) -> np.ndarray:
    """Bit-shuffle each row; bs must be a multiple of 8*ts (full groups)."""
    if arr.shape[1] % (8 * type_size):
        raise ValueError("block size must be a multiple of 8*type_size")
    if type_size in _SWAR_BIT_SHUFFLE:
        fn, quant = _SWAR_BIT_SHUFFLE[type_size]
        w = _view_as(arr, np.uint32, quant)
        if w is not None:
            return np.asarray(fn(jnp.asarray(w))).view(np.uint8)
    return _run(_bit_shuffle_batch_dev, arr, type_size)


def bit_unshuffle_batch(arr: np.ndarray, type_size: int) -> np.ndarray:
    if arr.shape[1] % (8 * type_size):
        raise ValueError("block size must be a multiple of 8*type_size")
    if type_size in _SWAR_BIT_UNSHUFFLE:
        fn, quant = _SWAR_BIT_UNSHUFFLE[type_size]
        w = _view_as(arr, np.uint32, quant)
        if w is not None:
            return np.asarray(fn(jnp.asarray(w))).view(np.uint8)
    return _run(_bit_unshuffle_batch_dev, arr, type_size)
