"""tpu_blosc benchmark — prints ONE JSON line for the driver.

Headline metric: end-to-end shuffle+LZ4 chunked compress throughput on the
BASELINE config-3-style input (64 MiB f32 ramp, level 5, byte shuffle,
typeSize 4) — directly comparable to the reference's published LZ4
compress number (3.31 GB/s on Apple M3 Max, README.md:119; BASELINE.md).

Extra fields report decompress throughput, device filter/codec
throughput, compression ratio, and backend details; the single required
schema keys are metric/value/unit/vs_baseline.

Every DEVICE bench runs in its own killable subprocess, one after
another, so exactly one process holds the card at a time; the parent
never starts an accelerator backend.  Children os._exit(0) after
printing, and the parent os._exit(0)s after its one JSON line.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# Watchdog: if anything in the PARENT hangs, the caller still gets ONE
# JSON line with whatever was measured.
# ---------------------------------------------------------------------------
_RECORD = {
    "metric": "shuffle_lz4_compress_throughput",
    "value": 0.0,
    "unit": "GB/s",
    "vs_baseline": 0.0,
    "watchdog": "fired before host bench completed",
}


def _watchdog(signum, frame):  # pragma: no cover - only fires on hangs
    print(json.dumps(_RECORD), flush=True)
    os._exit(0)


BASELINE_LZ4_COMPRESS_GBPS = 3.310  # reference README.md:119
N = 64 * 1024 * 1024
BLOCK = 1024 * 1024  # matches DEFAULT_AUTO_BLOCK (L2-resident sweet spot)
# best-of-N against the shared host's run-to-run variance (±30% observed)
REPS = 9


def _best(fn, reps=REPS):
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = min(best, dt)
    return best, out


def bench_host_pipeline() -> dict:
    import tpu_blosc as blosc
    from tpu_blosc.options import Options

    data = np.arange(N // 4, dtype=np.float32).tobytes()
    opts = Options(block_size=BLOCK)  # LZ4, level 5, SHUFFLE, ts 4

    # warmup
    comp = blosc.compress_with_options(data, opts)
    blosc.decompress(comp)

    t_comp, comp = _best(lambda: blosc.compress_with_options(data, opts))
    t_dec, out = _best(lambda: blosc.decompress(comp))
    assert out == data, "roundtrip failed"

    # single-block 1 MiB config (BASELINE cfg 1): exercises the segment-
    # parallel frame encode + seam-scan parallel decode (round 3)
    n1 = 1 << 20
    d1 = np.arange(n1 // 4, dtype=np.float32).tobytes()
    c1 = blosc.compress(d1)
    t1c, c1 = _best(lambda: blosc.compress(d1), reps=12)
    t1d, o1 = _best(lambda: blosc.decompress(c1), reps=12)
    assert o1 == d1, "single-block roundtrip failed"

    # ts=2 single-block 1 MiB — guards the round-4 fused plane extraction
    # for >= 256 KiB frames (byte-identical to the two-stage path; ts=2
    # roughly doubled: 13-18 -> 22-26 GB/s measured)
    d2 = (np.arange(n1 // 2, dtype=np.int16) % 3000).tobytes()
    c2 = blosc.compress(d2, blosc.LZ4, 5, blosc.SHUFFLE, 2)
    t2c, c2 = _best(
        lambda: blosc.compress(d2, blosc.LZ4, 5, blosc.SHUFFLE, 2), reps=12
    )
    t2d, o2 = _best(lambda: blosc.decompress(c2), reps=12)
    assert o2 == d2, "ts=2 single-block roundtrip failed"

    # BloscLZ (codec 0, our extension) on the same single-block shape —
    # guards the sixth codec's native + parallel paths
    cb = blosc.compress(d1, blosc.BLOSCLZ)
    tbc, cb = _best(lambda: blosc.compress(d1, blosc.BLOSCLZ), reps=12)
    tbd, ob = _best(lambda: blosc.decompress(cb), reps=12)
    assert ob == d1, "blosclz roundtrip failed"

    # ZLIB on the same shape — guards the round-4 libdeflate encode path
    # (segmented + BFINAL-patched; reference baseline 507 MB/s)
    cz = blosc.compress(d1, blosc.ZLIB)
    tzc, cz = _best(lambda: blosc.compress(d1, blosc.ZLIB), reps=12)
    tzd, oz = _best(lambda: blosc.decompress(cz), reps=12)
    assert oz == d1, "zlib roundtrip failed"

    # Snappy / ZSTD / LZ4HC on the 1 MiB single-block shape — round-5
    # VERDICT item: every codec the registry ships gets a guarded floor
    # (a silent collapse of the Snappy parallel path or the ZSTD tier
    # cache passed CI before this)
    cs = blosc.compress(d1, blosc.SNAPPY)
    tsc, cs = _best(lambda: blosc.compress(d1, blosc.SNAPPY), reps=12)
    tsd, osn = _best(lambda: blosc.decompress(cs), reps=12)
    assert osn == d1, "snappy roundtrip failed"
    czs = blosc.compress(d1, blosc.ZSTD)
    tzsc, czs = _best(lambda: blosc.compress(d1, blosc.ZSTD), reps=12)
    tzsd, ozs = _best(lambda: blosc.decompress(czs), reps=12)
    assert ozs == d1, "zstd roundtrip failed"
    ch = blosc.compress(d1, blosc.LZ4HC)
    thc, ch = _best(lambda: blosc.compress(d1, blosc.LZ4HC), reps=12)
    thd, oh = _best(lambda: blosc.decompress(ch), reps=12)
    assert oh == d1, "lz4hc roundtrip failed"

    # 16 MiB f32 bitshuffle (BASELINE config 4's amber row): guards the
    # fixed-offset scan encoder + word-walk emitter and the SWAR bit
    # filters end-to-end
    nbs = 16 << 20
    dbs = np.linspace(0, 1, nbs // 4, dtype=np.float32).tobytes()
    obs = Options(shuffle=blosc.BITSHUFFLE, type_size=4)
    cbs = blosc.compress_with_options(dbs, obs)
    tbsc, cbs = _best(
        lambda: blosc.compress_with_options(dbs, obs), reps=5
    )
    tbsd, obsd = _best(lambda: blosc.decompress(cbs), reps=5)
    assert obsd == dbs, "bitshuffle roundtrip failed"

    # batch API on the reference's own 100 KB config: 64 frames per call,
    # whole small frames scheduled across the SpinPool (per-frame
    # parallelism stays impossible below 256 KiB on this host — see
    # kFrameSegMin; batching is how the small-frame regime engages all
    # cores).  Aggregate GB/s over the batch.
    db = bytes(bytearray(i % 256 for i in range(100 * 1024)))

    # scalar 100 KB call — the reference's own benchmark point (round 4:
    # fused plane-parallel encode + compress() fast lane; was 8-10 serial)
    f100 = blosc.compress(db)
    for _ in range(300):  # warm the pool + malloc arena at this size
        blosc.compress(db)
    t100c, f100 = _best(lambda: blosc.compress(db), reps=400)
    t100d, o100 = _best(lambda: blosc.decompress(f100), reps=400)
    assert o100 == db, "100 KB scalar roundtrip failed"

    items = [db] * 64
    nb_total = len(db) * 64
    fb = blosc.compress_batch(items)
    assert fb[0] == blosc.compress(db), "batch bytes diverge from scalar"
    tbat_c, fb = _best(lambda: blosc.compress_batch(items), reps=10)
    tbat_d, ob2 = _best(lambda: blosc.decompress_batch(fb), reps=10)
    assert ob2 == items, "batch roundtrip failed"
    return {
        "compress_gbps": N / t_comp / 1e9,
        "decompress_gbps": N / t_dec / 1e9,
        "ratio": N / len(comp),
        "single_block_1mib_compress_gbps": n1 / t1c / 1e9,
        "single_block_1mib_decompress_gbps": n1 / t1d / 1e9,
        "single_block_1mib_ts2_compress_gbps": n1 / t2c / 1e9,
        "single_block_1mib_ts2_decompress_gbps": n1 / t2d / 1e9,
        "blosclz_1mib_compress_gbps": n1 / tbc / 1e9,
        "blosclz_1mib_decompress_gbps": n1 / tbd / 1e9,
        "zlib_1mib_compress_gbps": n1 / tzc / 1e9,
        "zlib_1mib_decompress_gbps": n1 / tzd / 1e9,
        "snappy_1mib_compress_gbps": n1 / tsc / 1e9,
        "snappy_1mib_decompress_gbps": n1 / tsd / 1e9,
        "zstd_1mib_compress_gbps": n1 / tzsc / 1e9,
        "zstd_1mib_decompress_gbps": n1 / tzsd / 1e9,
        "lz4hc_1mib_compress_gbps": n1 / thc / 1e9,
        "lz4hc_1mib_decompress_gbps": n1 / thd / 1e9,
        "bitshuffle_16mib_f32_compress_gbps": nbs / tbsc / 1e9,
        "bitshuffle_16mib_f32_decompress_gbps": nbs / tbsd / 1e9,
        "batch_100kb_compress_gbps": nb_total / tbat_c / 1e9,
        "batch_100kb_decompress_gbps": nb_total / tbat_d / 1e9,
        "scalar_100kb_compress_gbps": len(db) / t100c / 1e9,
        "scalar_100kb_decompress_gbps": len(db) / t100d / 1e9,
        "backend": blosc.backend_name(),
    }


# ---------------------------------------------------------------------------
# device stages (each runs in its own subprocess — see module docstring)
# ---------------------------------------------------------------------------


def _match_bench_data() -> np.ndarray:
    """256 MiB of dense-but-compressible f32: tiled 256-element pattern +
    1% noise — data the RLE strategy can't touch, the BASELINE dense-
    segment north-star case."""
    rng = np.random.default_rng(5)
    n_el = 64 * 1024 * 1024
    pattern = rng.random(256).astype(np.float32)
    data = np.tile(pattern, n_el // 256)
    hit = rng.choice(data.size, data.size // 100, replace=False)
    data[hit] += rng.random(hit.size).astype(np.float32) * 0.01
    return data


def stage_device_filter() -> dict:
    """Device batched shuffle throughput — the XLA kernel paths.

    Runs K kernel applications inside ONE jitted fori_loop and takes the
    SLOPE between two K values, so dispatch and sync costs cancel."""
    import jax

    from tpu_blosc.filters import batched as fb

    if jax.default_backend() == "cpu":
        return {}
    arr = jax.device_put(
        np.arange(N // 4, dtype=np.int32)
        .view(np.uint8)
        .reshape(N // BLOCK, BLOCK)
    )
    arr_w = jax.device_put(
        np.arange(N // 4, dtype=np.uint32).reshape(N // BLOCK, BLOCK // 4)
    )
    jax.block_until_ready((arr, arr_w))
    np.asarray(arr[0, :8])  # one real fetch before timing
    out = {"device": jax.devices()[0].device_kind}
    K_LO, K_HI = 8, 72

    def timed_loop(fn, x, k):
        @jax.jit
        def prog(x):
            return jax.lax.fori_loop(0, k, lambda i, a: fn(a), x)

        r = prog(x)  # compile + warm
        jax.block_until_ready(r)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            r = prog(x)
            jax.block_until_ready(r)
            best = min(best, time.perf_counter() - t0)
        return best

    for key, fn, x in (
        ("device_shuffle_gbps", lambda a: fb._shuffle_batch_dev(a, 4), arr),
        ("device_bitshuffle_gbps",
         lambda a: fb._bit_shuffle_batch_dev(a, 4), arr),
        # SWAR word-transpose ts=4 paths (the production device filter)
        ("device_shuffle_u32_gbps", fb._shuffle_batch_dev_u32, arr_w),
        ("device_unshuffle_u32_gbps", fb._unshuffle_batch_dev_u32, arr_w),
        ("device_bitshuffle_u32_gbps", fb._bit_shuffle_batch_dev_u32, arr_w),
        ("device_bitunshuffle_u32_gbps",
         fb._bit_unshuffle_batch_dev_u32, arr_w),
    ):
        t_lo = timed_loop(fn, x, K_LO)
        t_hi = timed_loop(fn, x, K_HI)
        per_iter = max((t_hi - t_lo) / (K_HI - K_LO), 1e-9)
        out[key] = N / per_iter / 1e9

    return out


def stage_device_match() -> dict:
    """Device match-discovery codec vs plain transfer (compress direction)."""
    import jax

    import tpu_blosc as blosc
    from tpu_blosc import device as tbdev
    from tpu_blosc.options import Options

    if jax.default_backend() == "cpu":
        return {}
    x = jax.device_put(_match_bench_data())
    jax.block_until_ready(x)
    opts = Options(block_size=BLOCK)

    def measure():
        t_match, fm = _best(
            lambda: tbdev.compress_array(x, opts, strategy="match"), reps=3
        )
        t_xfer, ft = _best(
            lambda: tbdev.compress_array(x, opts, strategy="transfer"), reps=2
        )
        assert blosc.decompress(fm) == blosc.decompress(ft)
        return {
            "device_match_s": round(t_match, 2),
            "device_transfer_s": round(t_xfer, 2),
            "device_match_speedup": round(t_xfer / t_match, 2),
        }

    return measure()


def stage_device_decode() -> dict:
    """Decode direction: records decode end-to-end vs plain upload, plus
    the ON-DEVICE reconstruct throughput (excluding the link) — the number
    the 'records decode stays for symmetric links' claim rests on."""
    import jax

    import tpu_blosc as blosc
    from tpu_blosc import device as tbdev
    from tpu_blosc.options import Options

    if jax.default_backend() == "cpu":
        return {}
    data = _match_bench_data()
    frame = blosc.compress_with_options(
        data.tobytes(), Options(block_size=BLOCK)
    )
    nbytes = data.size * 4

    captured = {}
    real = tbdev._device_match_decode

    def spy(*a):
        captured["a"] = a
        return real(*a)

    tbdev._device_match_decode = spy
    try:
        # warm: compiles the decode programs
        out = tbdev.decompress_array(frame, np.float32, strategy="records")
        np.asarray(out[:8])
        t_records = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = tbdev.decompress_array(frame, np.float32, strategy="records")
            np.asarray(out[:8])  # sync
            t_records = min(t_records, time.perf_counter() - t0)
    finally:
        tbdev._device_match_decode = real
    if "a" not in captured:
        return {"device_decode_error": "records path did not engage"}
    assert np.array_equal(np.asarray(out[:1024]), data[:1024])

    t_transfer = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out2 = tbdev.decompress_array(frame, np.float32, strategy="transfer")
        np.asarray(out2[:8])
        t_transfer = min(t_transfer, time.perf_counter() - t0)

    # on-device reconstruct program alone (records already resident)
    args = captured["a"]
    r = real(*args)
    jax.block_until_ready(r)
    np.asarray(r[:8])  # honest-timing fetch
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        r = real(*args)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / reps
    return {
        "device_decode_records_s": round(t_records, 2),
        "device_decode_transfer_s": round(t_transfer, 2),
        "device_decode_fill_gbps": round(nbytes / dt / 1e9, 1),
    }


def stage_device_checkpoint() -> dict:
    """Device-leaf checkpoint pipeline (round-3 stage-split commit):
    save_pytree runs leaf k+1's device filter + link fetch while leaf k
    takes the host codec + file write; load_pytree(device=True) overlaps
    host decode with device_put.  Reports end-to-end GB/s and the
    pipeline-vs-serial speedup."""
    import tempfile

    import jax

    from tpu_blosc import checkpoint

    if jax.default_backend() == "cpu":
        return {}
    n_leaves, leaf_elems = 8, (8 << 20) // 4
    # dense-but-compressible leaves (tiled pattern + sparse noise, the
    # match bench's data class) so the match/records arms engage; the
    # transfer arms run on the same bytes for a fair comparison
    rng = np.random.default_rng(11)
    pattern = rng.random(256).astype(np.float32)
    tree = {}
    for i in range(n_leaves):
        leaf = np.tile(pattern * (i + 1), leaf_elems // 256)
        hit = rng.choice(leaf.size, leaf.size // 100, replace=False)
        leaf[hit] += rng.random(hit.size).astype(np.float32) * 0.01
        tree[f"layer{i}"] = jax.device_put(leaf)
    jax.block_until_ready(list(tree.values()))
    np.asarray(tree["layer0"][:8])  # honest timing needs one real fetch
    nbytes = n_leaves * leaf_elems * 4
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt.tpbs")

        def save():
            if os.path.exists(path):
                os.unlink(path)
            checkpoint.save_pytree(path, tree)

        def load():
            state = checkpoint.load_pytree(path, device=True)
            jax.block_until_ready(state)
            np.asarray(state["layer0"][:8])
            return state

        def save_match():
            if os.path.exists(path):
                os.unlink(path)
            checkpoint.save_pytree(path, tree, strategy="match")

        def load_records():
            state = checkpoint.load_pytree(
                path, device=True, strategy="records"
            )
            jax.block_until_ready(state)
            np.asarray(state["layer0"][:8])
            return state

        save()  # warm: compiles the device filter programs
        state = load()
        assert np.array_equal(
            np.asarray(state["layer3"][:1024]), np.asarray(tree["layer3"][:1024])
        ), "checkpoint roundtrip failed"
        t_save, _ = _best(save, reps=3)
        t_load, _ = _best(load, reps=3)
        os.environ["TPU_BLOSC_NO_CKPT_PIPELINE"] = "1"
        try:
            t_save_ser, _ = _best(save, reps=2)
            t_load_ser, _ = _best(load, reps=2)
        finally:
            del os.environ["TPU_BLOSC_NO_CKPT_PIPELINE"]
        # record-strategy arms: O(records) over the link instead of raw
        # bytes (save: device match discovery; load: device-side
        # reconstruct from literal records)
        save_match()  # warm (compiles the match pipeline at this shape)
        state = load_records()
        assert np.array_equal(
            np.asarray(state["layer5"][:1024]), np.asarray(tree["layer5"][:1024])
        ), "record-strategy roundtrip failed"
        t_save_match, _ = _best(save_match, reps=2)
        t_load_rec, _ = _best(load_records, reps=2)
    return {
        "checkpoint_device_save_gbps": round(nbytes / t_save / 1e9, 3),
        "checkpoint_device_load_gbps": round(nbytes / t_load / 1e9, 3),
        "checkpoint_device_save_speedup": round(t_save_ser / t_save, 2),
        "checkpoint_device_load_speedup": round(t_load_ser / t_load, 2),
        "checkpoint_device_save_match_gbps": round(
            nbytes / t_save_match / 1e9, 3
        ),
        "checkpoint_device_load_records_gbps": round(
            nbytes / t_load_rec / 1e9, 3
        ),
    }


STAGES = {
    "device_filter": (stage_device_filter, 360),
    "device_match": (stage_device_match, 540),
    "device_decode": (stage_device_decode, 540),
    "device_checkpoint": (stage_device_checkpoint, 660),
}


def _run_stage_subprocess(name: str, timeout: float) -> dict:
    """Run one device stage in a killable subprocess (own process group,
    so SIGKILL reaches every thread)."""
    try:
        child_env = {
            k: v for k, v in os.environ.items() if k != "TPU_BLOSC_NO_DEVICE"
        }
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--stage", name],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            start_new_session=True,
            env=child_env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
            return {f"{name}_error": f"timed out ({timeout:.0f}s), killed"}
        line = next(
            (
                ln
                for ln in reversed(out.decode(errors="replace").splitlines())
                if ln.startswith("{")
            ),
            None,
        )
        if line is None:
            return {f"{name}_error": f"no output (rc={proc.returncode})"}
        return json.loads(line)
    except Exception as exc:  # pragma: no cover - defensive
        return {f"{name}_error": str(exc)[:100]}


def _child_main(name: str) -> None:
    from tpu_blosc.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        result = STAGES[name][0]()
    except Exception as exc:
        result = {f"{name}_error": str(exc)[:100]}
    print(json.dumps(result), flush=True)
    os._exit(0)  # skip the runtime teardown


def _probe_device_present(timeout: float = 120.0) -> bool:
    """Backend probe in a killable subprocess, so the parent never starts
    a backend (it would hold the card the stages need)."""
    try:
        child_env = {
            k: v for k, v in os.environ.items() if k != "TPU_BLOSC_NO_DEVICE"
        }
        out = subprocess.run(
            [sys.executable, "-c",
             "import jax; print(jax.default_backend())"],
            capture_output=True, timeout=timeout, env=child_env,
        )
        return out.returncode == 0 and b"cpu" not in out.stdout
    except Exception:
        return False


def main() -> None:
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(2400)  # 4 device stages (each subprocess-bounded below)
    # the parent never needs a device: the host pipeline is host-only and
    # every device stage runs in its own subprocess
    os.environ["TPU_BLOSC_NO_DEVICE"] = "1"
    host = bench_host_pipeline()
    value = round(host["compress_gbps"], 3)
    # every numeric host metric flows into the JSON line (additive schema
    # — bench_guard floors a growing subset); value/vs_baseline stay the
    # headline keys
    _RECORD.update({
        "value": value,
        "vs_baseline": round(value / BASELINE_LZ4_COMPRESS_GBPS, 3),
        "backend": host["backend"],
    })
    for key, v in host.items():
        if key in ("compress_gbps", "backend"):
            continue
        _RECORD[key] = round(v, 1 if key == "ratio" else 3)
    _RECORD["watchdog"] = "fired during device benches (host numbers valid)"

    device_present = _probe_device_present()
    _RECORD["device_present"] = device_present
    if device_present:
        for name, (_, timeout) in STAGES.items():
            result = _run_stage_subprocess(name, timeout)
            _RECORD.update(
                {
                    k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in result.items()
                }
            )

    del _RECORD["watchdog"]
    signal.alarm(0)
    print(json.dumps(_RECORD), flush=True)
    os._exit(0)  # skip interpreter/runtime teardown


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        _child_main(sys.argv[2])
    else:
        main()
