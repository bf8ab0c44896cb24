"""Mesh sharding tests: batched device filters + mesh-invariance.

Runs on the 8-device virtual CPU mesh forced by conftest.py.  The key
property is mesh-invariance: frames are bit-identical whatever the mesh
shape — the distributed analogue of the reference's SIMD-vs-generic
equality tests (SURVEY §4).
"""

import jax
import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc import chunk
from tpu_blosc.dist import mesh as dmesh
from tpu_blosc.filters import batched as fb
from tpu_blosc.filters import reference as ref
from tpu_blosc.format import Shuffle
from tpu_blosc.options import Options


def _blocks(nb, bs, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (nb, bs), dtype=np.uint8)


# ---------------------------------------------------------------------------
# batched filters vs oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ts", [2, 4, 8, 16])
def test_shuffle_batch_matches_oracle(ts):
    arr = _blocks(5, 64 * ts)
    got = fb.shuffle_batch(arr, ts)
    for i in range(arr.shape[0]):
        assert np.array_equal(got[i], ref.shuffle_bytes(arr[i].tobytes(), ts))
    back = fb.unshuffle_batch(got, ts)
    assert np.array_equal(back, arr)


@pytest.mark.parametrize("ts", [2, 4, 8])
def test_bit_shuffle_batch_matches_oracle(ts):
    arr = _blocks(4, 8 * ts * 16, seed=ts)
    got = fb.bit_shuffle_batch(arr, ts)
    for i in range(arr.shape[0]):
        assert np.array_equal(got[i], ref.bit_shuffle(arr[i].tobytes(), ts))
    back = fb.bit_unshuffle_batch(got, ts)
    assert np.array_equal(back, arr)


def test_batch_rejects_misaligned():
    with pytest.raises(ValueError):
        fb.shuffle_batch(_blocks(2, 65), 4)
    with pytest.raises(ValueError):
        fb.bit_shuffle_batch(_blocks(2, 36), 4)


# ---------------------------------------------------------------------------
# sharded filter: device count and padding
# ---------------------------------------------------------------------------


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", [Shuffle.SHUFFLE, Shuffle.BITSHUFFLE])
def test_filter_blocks_sharded_mesh_invariant(n_dev, mode):
    arr = _blocks(6, 512)  # 6 blocks does NOT divide most mesh sizes
    m = dmesh.block_mesh(n_dev)
    got = dmesh.filter_blocks_sharded(arr, 4, mode, m)
    orc = (
        ref.shuffle_bytes if mode == Shuffle.SHUFFLE else ref.bit_shuffle
    )
    for i in range(arr.shape[0]):
        assert np.array_equal(got[i], orc(arr[i].tobytes(), 4)), (n_dev, i)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_unfilter_blocks_sharded_roundtrip(n_dev):
    arr = _blocks(7, 256, seed=9)
    m = dmesh.block_mesh(n_dev)
    s = dmesh.filter_blocks_sharded(arr, 8, Shuffle.SHUFFLE, m)
    back = dmesh.unfilter_blocks_sharded(s, 8, Shuffle.SHUFFLE, m)
    assert np.array_equal(back, arr)


# ---------------------------------------------------------------------------
# end-to-end mesh compress: bit-identical frames for every mesh size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [Shuffle.SHUFFLE, Shuffle.BITSHUFFLE])
def test_compress_chunked_mesh_invariance(shuffle):
    data = np.arange(100_000, dtype=np.float32).tobytes()
    opts = Options(shuffle=shuffle, type_size=4, block_size=32768)
    frames = []
    for n_dev in (1, 2, 8):
        m = dmesh.block_mesh(n_dev)
        frames.append(dmesh.compress_chunked_mesh(data, opts, m))
    assert frames[0] == frames[1] == frames[2]
    # and identical to the host (chunk.py) frame
    host_frame = blosc.compress_with_options(data, opts)
    assert frames[0] == host_frame
    # decodable by the plain API and by the mesh path
    assert blosc.decompress(frames[0]) == data
    assert dmesh.decompress_chunked_mesh(frames[0], dmesh.block_mesh(4)) == data


def test_mesh_decompress_single_block_frame_delegates():
    data = b"plain single block frame" * 10
    comp = blosc.compress(data, blosc.LZ4, 5, blosc.NOSHUFFLE, 1)
    assert dmesh.decompress_chunked_mesh(comp) == data


def test_mesh_roundtrip_with_ragged_tail():
    n = 3 * 16384 + 777  # tail block, not a multiple of anything
    data = (np.arange(n, dtype=np.uint8)).tobytes()
    opts = Options(block_size=16384, type_size=4)
    frame = dmesh.compress_chunked_mesh(data, opts, dmesh.block_mesh(8))
    assert blosc.decompress(frame) == data
    assert dmesh.decompress_chunked_mesh(frame) == data


# ---------------------------------------------------------------------------
# multi-host assembly (P=1 degenerate case; slicing logic for any P)
# ---------------------------------------------------------------------------


def test_multihost_frame_identical_to_host_path():
    from tpu_blosc.dist import multihost

    data = np.arange(100_000, dtype=np.float32).tobytes()
    opts = Options(block_size=32768)
    frame = multihost.compress_chunked_multihost(len(data), data, opts)
    assert frame == blosc.compress_with_options(data, opts)
    assert blosc.decompress(frame) == data


def test_multihost_process_slices_partition_exactly():
    from tpu_blosc.dist.multihost import process_slice

    for n in (100_001, 4 * 65536, 65536 - 1, 7 * 65536 + 3):
        for procs in (1, 2, 3, 8):
            bs = 16384
            covered = []
            for p in range(procs):
                s, e = process_slice(n, bs, p, procs)
                if e > s:  # empty trailing slices sit at n
                    assert s % bs == 0
                covered.append((s, e))
            # contiguous, ordered, exact cover
            assert covered[0][0] == 0
            assert covered[-1][1] == n
            for (s0, e0), (s1, e1) in zip(covered, covered[1:]):
                assert e0 == s1


def test_multihost_wrong_slice_rejected():
    from tpu_blosc.dist import multihost
    from tpu_blosc.errors import InvalidDataError

    data = np.arange(10_000, dtype=np.float32).tobytes()
    with pytest.raises(InvalidDataError):
        multihost.compress_chunked_multihost(
            len(data), data[:100], Options(block_size=4096)
        )


def test_mesh_compress_return_stats():
    """The shard_map step's explicit collectives produce usable cross-chip
    metadata: psum'd histogram + all_gathered per-block diff counts."""
    from tpu_blosc.dist import mesh as tb_mesh

    data = np.arange(24_576, dtype=np.float32).tobytes()  # 96 KiB
    opts = blosc.Options(block_size=16384)
    m = tb_mesh.block_mesh(4)
    frame, stats = tb_mesh.compress_chunked_mesh(
        data, opts, mesh=m, return_stats=True
    )
    assert blosc.decompress(frame) == data
    nb_full = len(data) // 16384
    assert stats.histogram.shape == (256,)
    # the histogram covers a uniform chunk sample of the filtered bytes
    # (exact accounting via sample_bytes; == all real bytes when the
    # per-device shard fits under the sampling cap)
    assert int(stats.histogram.sum()) == stats.sample_bytes
    assert 0 < stats.sample_bytes <= nb_full * 16384
    assert stats.block_diffs.shape == (nb_full,)
    # shuffled ramp planes are run-dominated: few diffs per block
    assert (stats.block_diffs < 16384).all()


def test_mesh_stats_histogram_sampling_engages():
    """Above the per-device cap the histogram covers a strict uniform
    sample (a full scatter histogram costs more than the filter), with
    sample_bytes giving the exact coverage and padding rows excluded."""
    from tpu_blosc.dist import mesh as tb_mesh

    # 6 MiB over 4 devices = 1.5 MiB/shard >> the 256 KiB cap; block
    # count chosen to force zero-padding rows on the last shard
    data = (np.arange((6 << 20) // 4, dtype=np.uint32) % 65536).tobytes()
    opts = blosc.Options(block_size=1 << 20)
    m = tb_mesh.block_mesh(4)
    frame, stats = tb_mesh.compress_chunked_mesh(
        data, opts, mesh=m, return_stats=True
    )
    assert blosc.decompress(frame) == data
    assert 0 < stats.sample_bytes < len(data)
    assert int(stats.histogram.sum()) == stats.sample_bytes
    assert (stats.histogram >= 0).all()


def test_compress_chunked_mesh_invariance_blosclz():
    """Codec 0 (our extension) through the mesh path: frames identical
    across mesh sizes AND to the host pipeline."""
    data = np.arange(60_000, dtype=np.float32).tobytes()
    opts = Options(codec=blosc.BLOSCLZ, type_size=4, block_size=16384)
    frames = [
        dmesh.compress_chunked_mesh(data, opts, dmesh.block_mesh(n))
        for n in (1, 4, 8)
    ]
    assert frames[0] == frames[1] == frames[2]
    assert frames[0] == blosc.compress_with_options(data, opts)
    assert blosc.decompress(frames[0]) == data
