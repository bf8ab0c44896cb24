#!/usr/bin/env python3
"""Smoke test of the device codec path on an NVIDIA GPU, end to end.

    python chip_smoke.py               # one card: phases A-F
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Every input is generated from ``--seed``; nothing is read from outside
the checkout.  Each comparison is exact (zero tolerance): frames and
arrays are byte streams, compared bit for bit.  The codec path has no
floating-point matrix product, so TF32 or any other matmul precision
setting cannot affect a result.

Phases (one card):
  A  environment: backend and devices, the card's name and power limit,
     host cores and memory, the native build, zstandard, compile cache.
     Fails unless the backend is ``gpu`` and the native runtime loaded.
  B  device arrays: 1 GiB f32 (LZ4, byte shuffle, 1 MiB blocks), 1 GiB
     bf16 (ts=2), bitshuffle ts=4, and 64 MiB f64 ZSTD ts=8 through
     compress_array / decompress_array ("transfer" and "device").
  C  checkpoint: GPT-2 small training state (bf16 weights, fp32 master,
     fp32 Adam m and v; ~1.7 GB) through save_pytree / load_pytree /
     load_leaf.
  D  the record strategies ("match", "rle", "records") at 256 MiB.
  E  filter kernel timings: XLA word (SWAR) kernels vs the u8
     reshape-transpose vs a device copy of the same bytes.
  F  the card-only tests (pytest marker ``gpu``), in this process.

The last line is one JSON object, printed only when every phase passed;
any failure raises, prints its traceback and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))

MiB = 1 << 20
GiB = 1 << 30
# GPT-2 small (Radford et al. 2019, the 124M-parameter configuration)
GPT2_SMALL = {"n_layer": 12, "d_model": 768, "vocab": 50257, "n_ctx": 1024}


class SmokeFailure(AssertionError):
    """A phase's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@dataclass
class Ctx:
    """What every phase needs to know about the run."""

    platform: str       # the platform every array must land on
    card: str           # nvidia-smi name and power limit, for every number
    seed: int = 0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _uint_of(itemsize: int):
    import jax.numpy as jnp

    return {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32, 8: jnp.uint64}[itemsize]


def same_bits(a, b) -> bool:
    """Exact equality of two arrays (dtype, shape and every bit)."""
    import jax
    import jax.numpy as jnp

    a, b = jnp.asarray(a), jnp.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    u = _uint_of(a.dtype.itemsize)
    return bool(jnp.array_equal(
        jax.lax.bitcast_convert_type(a, u), jax.lax.bitcast_convert_type(b, u)
    ))


def check_on(ctx: Ctx, arr, what: str, n_devices: int = 1) -> None:
    devs = arr.devices()
    check(
        all(d.platform == ctx.platform for d in devs),
        f"{what} is on {sorted({d.platform for d in devs})}, "
        f"not {ctx.platform}",
    )
    check(len(devs) == n_devices,
          f"{what} spans {len(devs)} devices, expected {n_devices}")


def field(n: int, dtype, seed: int, sharding=None):
    """n elements on device: the first half a smooth field (a ramp with
    seeded noise in the low 4 mantissa bits), the second half seeded
    normal noise (incompressible blocks, which exercise memcpy)."""
    import jax
    import jax.numpy as jnp

    def body(key):
        h = n // 2
        k1, k2 = jax.random.split(key)
        ramp = jnp.linspace(0.0, 1000.0, h, dtype=jnp.float32)
        low = jax.random.randint(k1, (h,), 0, 16, dtype=jnp.uint32)
        smooth = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(ramp, jnp.uint32) ^ low, jnp.float32
        )
        rough = jax.random.normal(k2, (n - h,), jnp.float32)
        return jnp.concatenate([smooth, rough]).astype(dtype)

    fn = jax.jit(body, out_shardings=sharding) if sharding else jax.jit(body)
    return jax.block_until_ready(fn(jax.random.PRNGKey(seed)))


class Spy:
    """Wrap a module function to record its calls and results."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.results: list = []

    def __enter__(self):
        def spy(*a, **k):
            r = self.real(*a, **k)
            self.results.append(r)
            return r

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def check_block_against_oracle(frame: bytes, host: bytes, k: int,
                               decode, label: str) -> str:
    """Decode block ``k`` of a split frame with ``decode`` (the codec)
    and the NumPy reference unfilter; compare with the source bytes."""
    import numpy as np

    from tpu_blosc.chunk import parse_block_table
    from tpu_blosc.filters import reference
    from tpu_blosc.format import parse_header

    header = parse_header(frame)
    entries, offset = parse_block_table(frame, header)
    k = k % len(entries)
    start = offset + sum(size for size, _ in entries[:k])
    size, memcpy = entries[k]
    bs = header.block_size
    want = host[k * bs : k * bs + bs]
    payload = frame[start : start + size]
    if memcpy:
        got = payload
        how = "memcpy"
    else:
        filtered = np.frombuffer(decode(payload, len(want)), np.uint8)
        unfilter = (reference.bit_unshuffle if header.has_bitshuffle
                    else reference.unshuffle_bytes)
        got = unfilter(filtered, header.type_size).tobytes()
        how = "decoded"
    check(got == want, f"{label}: block {k} differs from the oracle")
    return f"block {k} {how} == source"


def device_time(fn, *args, reps: int = 15) -> float:
    """Median seconds of fn(*args) until its result is ready (warmed)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_native() -> None:
    """The one documented build command, before anything else runs."""
    from_here = subprocess.run(
        [sys.executable, "-m", "tpu_blosc.native"], cwd=ROOT,
        capture_output=True, text=True, timeout=900,
    )
    log("A", "native build: " + (from_here.stdout.strip()
                                 or from_here.stderr.strip()[-2000:]))
    check(from_here.returncode == 0, "python -m tpu_blosc.native failed")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def phase_env(platform: str, n_devices: int) -> Ctx:
    import jax

    from tpu_blosc.compile_cache import compile_cache_dir
    from tpu_blosc.native import backend as nb

    backend = jax.default_backend()
    devices = jax.devices()
    log("A", f"jax {jax.__version__} backend={backend} "
             f"devices={len(devices)} kind={devices[0].device_kind}")
    card = card_line()
    print(card, flush=True)
    log("A", f"nproc={os.cpu_count()} tpb_num_threads={nb.num_threads()}")
    try:
        free = subprocess.run(["free", "-g"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
        log("A", "free -g:\n" + free)
    except (OSError, subprocess.SubprocessError):
        log("A", "free -g: unavailable")
    info = nb.build_info()
    log("A", f"native available={nb.available()} zstd={nb.zstd_available()} "
             f"fastcall={info.get('fastcall')} flags={info.get('flags')} "
             f"path={info.get('path')}")
    try:
        import zstandard  # noqa: F401

        log("A", "zstandard: importable")
    except ImportError:
        log("A", "zstandard: not installed (ZSTD served by libzstd)")
    log("A", f"compile cache: {compile_cache_dir()}")
    check(backend == platform, f"JAX backend is {backend!r}, not {platform!r}")
    check(all(d.platform == platform for d in devices),
          "a device is not on the expected platform")
    check(len(devices) >= n_devices,
          f"{len(devices)} devices, {n_devices} needed")
    check(nb.available(), "native runtime unavailable: "
                          + str(info.get("error")))
    return Ctx(platform=platform, card=card)


def _roundtrip_array(ctx: Ctx, x, opts, label: str, oracle_decode) -> None:
    import numpy as np

    import tpu_blosc as blosc
    from tpu_blosc import device as tbdev

    t0 = time.perf_counter()
    frame = blosc.compress_array(x, opts)
    host = np.asarray(x).tobytes()
    ref = blosc.compress_with_options(host, opts)
    check(frame == ref, f"{label}: device frame differs from the host frame")
    n = len(host)
    log("B", f"{label}: {n / MiB:.0f} MiB -> {len(frame)} B frame, equals "
             "compress_with_options byte for byte")
    for k in (0, -1):
        log("B", f"{label}: " + check_block_against_oracle(
            frame, host, k, oracle_decode, label))
    out = blosc.decompress_array(frame, x.dtype, shape=x.shape,
                                 strategy="transfer")
    check_on(ctx, out, f"{label} transfer result")
    check(same_bits(out, x), f"{label}: transfer decode differs")
    with Spy(tbdev, "_decompress_array_devfilter") as spy:
        out = blosc.decompress_array(frame, x.dtype, shape=x.shape,
                                     strategy="device")
    check(len(spy.results) == 1 and spy.results[0] is not None,
          f"{label}: strategy='device' fell back to the host unfilter")
    check_on(ctx, out, f"{label} device result")
    check(same_bits(out, x), f"{label}: device decode differs")
    log("B", f"{label}: transfer and device decodes bit-exact "
             f"({time.perf_counter() - t0:.1f} s)")


def phase_device_arrays(ctx: Ctx, nbytes: int = GiB,
                        zstd_bytes: int = 64 * MiB) -> None:
    import jax.numpy as jnp

    from tpu_blosc.codecs import lz4_ref
    from tpu_blosc.codecs.registry import get_codec
    from tpu_blosc.format import Codec, Shuffle
    from tpu_blosc.options import Options

    lz4 = lz4_ref.decompress_block
    x = field(nbytes // 4, jnp.float32, ctx.seed)
    check_on(ctx, x, "f32 input")
    _roundtrip_array(ctx, x, Options(type_size=4), "f32 lz4 shuffle", lz4)
    _roundtrip_array(ctx, x, Options(type_size=4, shuffle=Shuffle.BITSHUFFLE),
                     "f32 lz4 bitshuffle", lz4)
    del x
    x = field(nbytes // 2, jnp.bfloat16, ctx.seed + 1)
    _roundtrip_array(ctx, x, Options(type_size=2), "bf16 lz4 shuffle", lz4)
    del x
    x = field(zstd_bytes // 8, jnp.float64, ctx.seed + 2)
    zstd = get_codec(Codec.ZSTD)
    check(zstd is not None, "ZSTD codec is not registered")
    _roundtrip_array(ctx, x, Options(codec=Codec.ZSTD, type_size=8),
                     "f64 zstd shuffle", zstd.decompress)


def gpt2_shapes(n_layer: int, d_model: int, vocab: int, n_ctx: int) -> dict:
    """Parameter shapes of a GPT-2 model, leaf by leaf (tied embedding)."""
    d = d_model
    layer = {
        "ln_1": {"g": (d,), "b": (d,)},
        "attn": {"c_attn": {"w": (d, 3 * d), "b": (3 * d,)},
                 "c_proj": {"w": (d, d), "b": (d,)}},
        "ln_2": {"g": (d,), "b": (d,)},
        "mlp": {"c_fc": {"w": (d, 4 * d), "b": (4 * d,)},
                "c_proj": {"w": (4 * d, d), "b": (d,)}},
    }
    return {"wte": (vocab, d), "wpe": (n_ctx, d),
            "h": [layer] * n_layer, "ln_f": {"g": (d,), "b": (d,)}}


def training_state(shapes: dict, seed: int) -> dict:
    """bf16 weights, fp32 master weights and fp32 Adam m, v on device."""
    import jax
    import jax.numpy as jnp

    is_shape = lambda s: isinstance(s, tuple)  # noqa: E731
    leaves, treedef = jax.tree_util.tree_flatten(shapes, is_leaf=is_shape)

    @partial(jax.jit, static_argnums=(1,))
    def gen(key, shape):
        k1, k2, k3 = jax.random.split(key, 3)
        master = jax.random.normal(k1, shape, jnp.float32) * 0.02
        m = jax.random.normal(k2, shape, jnp.float32) * 1e-3
        v = jnp.square(jax.random.normal(k3, shape, jnp.float32) * 1e-3)
        return master.astype(jnp.bfloat16), master, m, v

    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    parts = [gen(k, s) for k, s in zip(keys, leaves)]
    tree = lambda i: jax.tree_util.tree_unflatten(  # noqa: E731
        treedef, [p[i] for p in parts])
    state = {"params": tree(0), "master": tree(1),
             "adam": {"m": tree(2), "v": tree(3)}, "step": 1000}
    return jax.block_until_ready(state)


def phase_checkpoint(ctx: Ctx, config: dict = GPT2_SMALL) -> None:
    import jax

    from tpu_blosc import checkpoint

    state = training_state(gpt2_shapes(**config), ctx.seed + 3)
    arrays = jax.tree_util.tree_leaves(state["master"])
    n_params = sum(a.size for a in arrays)
    nbytes = sum(a.nbytes for a in jax.tree_util.tree_leaves(state)
                 if hasattr(a, "nbytes"))
    log("C", f"GPT-2 {config}: {n_params} parameters, "
             f"{nbytes / 1e9:.3f} GB of training state on device")
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "state.tpbs")
        t0 = time.perf_counter()
        checkpoint.save_pytree(path, state)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = checkpoint.load_pytree(path, device=True)
        jax.block_until_ready(back)
        t_load = time.perf_counter() - t0
        got = jax.tree_util.tree_leaves(back)
        want = jax.tree_util.tree_leaves(state)
        check(jax.tree_util.tree_structure(back)
              == jax.tree_util.tree_structure(state),
              "checkpoint tree structure changed")
        for i, (a, b) in enumerate(zip(got, want)):
            if hasattr(b, "dtype"):
                check_on(ctx, a, f"checkpoint leaf {i}")
                check(same_bits(a, b), f"checkpoint leaf {i} differs")
            else:
                check(a == b, f"checkpoint scalar leaf {i} differs")
        key = "params/h/0/mlp/c_fc/w"
        leaf = checkpoint.load_leaf(path, key, device=True)
        check(same_bits(leaf, state["params"]["h"][0]["mlp"]["c_fc"]["w"]),
              f"load_leaf({key}) differs")
    log("C", f"save_pytree -> {size} B file, load_pytree(device=True): "
             f"{len(got)} leaves bit-exact, load_leaf bit-exact "
             f"(save {t_save:.1f} s, load {t_load:.1f} s, set-up included)")


def periodic_data(n: int, seed: int):
    """Dense-but-compressible f32: a seeded 256-element pattern, tiled,
    with small noise on 1% of the elements — data the match strategy
    is built for."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def body(key):
        k1, k2, k3 = jax.random.split(key, 3)
        pattern = jax.random.uniform(k1, (256,), jnp.float32)
        x = jnp.tile(pattern, n // 256)
        hit = jax.random.bernoulli(k2, 0.01, (n,))
        noise = jax.random.uniform(k3, (n,), jnp.float32) * 0.01
        return jnp.where(hit, x + noise, x)

    return jax.block_until_ready(body(jax.random.PRNGKey(seed)))


def step_data(n: int):
    """f32 steps of 4096 equal elements: run-sparse byte planes."""
    import jax.numpy as jnp

    return (jnp.arange(n, dtype=jnp.int32) // 4096).astype(jnp.float32)


def phase_strategies(ctx: Ctx, nbytes: int = 256 * MiB,
                     block: int = MiB) -> None:
    import numpy as np

    import tpu_blosc as blosc
    from tpu_blosc import device as tbdev
    from tpu_blosc.options import Options

    opts = Options(type_size=4, block_size=block)
    cases = (("match", periodic_data(nbytes // 4, ctx.seed + 4)),
             ("rle", step_data(nbytes // 4)))
    for strategy, x in cases:
        host = np.asarray(x).tobytes()
        with Spy(tbdev, "_device_filter_fetch") as fetch:
            frame = blosc.compress_array(x, opts, strategy=strategy)
        check(not fetch.results,
              f"strategy={strategy!r} fell back to the transfer path")
        check(blosc.decompress(frame) == host,
              f"strategy={strategy!r}: host decoder disagrees")
        log("D", f"compress_array(strategy={strategy!r}): {nbytes / MiB:.0f} "
                 f"MiB -> {len(frame)} B, engaged, host decode exact")
        if strategy == "match":
            with Spy(tbdev, "_device_match_decode") as fill:
                out = blosc.decompress_array(frame, np.float32,
                                             strategy="records")
            check(len(fill.results) == 1,
                  "decompress_array(strategy='records') did not engage")
            check_on(ctx, out, "records result")
            check(same_bits(out, x), "records decode differs")
            log("D", "decompress_array(strategy='records'): engaged, "
                     "bit-exact")


def phase_kernel_times(ctx: Ctx, sizes=(256 * MiB, GiB),
                       reps: int = 15) -> dict:
    """Device time of each filter formulation at real widths (section 2
    of the bring-up: the measurement that decided the byte-plane
    kernels' removal)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_blosc import device as tbdev
    from tpu_blosc.filters import batched as fb

    bs = MiB if min(sizes) >= MiB else min(sizes) // 4
    results = {}

    def report(key: str, t: float, nbytes: int) -> None:
        results[key] = t
        log("E", f"{key}: {t * 1e3:.3f} ms, {nbytes / t / 1e9:.1f} GB/s of "
                 f"input | card: {ctx.card}")

    copy = jax.jit(lambda a: a + jnp.uint32(1))
    for n in sizes:
        nb = n // bs
        words = jax.device_put(
            np.arange(n // 4, dtype=np.uint32).reshape(nb, bs // 4))
        report(f"copy {n // MiB} MiB (elementwise u32 pass)",
               device_time(copy, words, reps=reps), n)
        for ts, dt in ((4, jnp.float32), (2, jnp.bfloat16)):
            tag = f"ts={ts} {n // MiB} MiB"
            x = jax.lax.bitcast_convert_type(words, dt).reshape(-1)
            u8 = jax.lax.bitcast_convert_type(words, jnp.uint8).reshape(nb, bs)
            report(f"{tag} shuffle SWAR words",
                   device_time(tbdev._device_filter_prep, x, nb, bs, ts, 1,
                               True, reps=reps), n)
            report(f"{tag} shuffle u8 transpose",
                   device_time(tbdev._device_filter_prep, x, nb, bs, ts, 1,
                               False, reps=reps), n)
            report(f"{tag} unshuffle SWAR words (device decode program)",
                   device_time(tbdev._dev_unfilter_words, words, 1,
                               np.dtype(dt).name, reps=reps), n)
            report(f"{tag} unshuffle u8 transpose",
                   device_time(fb._unshuffle_batch_dev, u8, ts, reps=reps), n)
            del x, u8
        del words
    n = min(256 * MiB, max(sizes))
    seg = bs // 4
    filt = jax.device_put(
        (np.arange(n, dtype=np.uint32) % 251).astype(np.uint8)
        .reshape(n // bs, bs))
    report(f"match core (plain XLA) {n // MiB} MiB",
           device_time(tbdev._device_match_core, filt, seg,
                       tbdev._match_offsets(seg), reps=max(reps // 3, 1)), n)
    return results


class _Outcomes:
    """pytest plugin: count test outcomes."""

    def __init__(self):
        self.counts: dict = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_card_tests(ctx: Ctx) -> None:
    """The card-only tests, in this process (tests/conftest.py leaves an
    already-started backend alone)."""
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main(
        [os.path.join(ROOT, "tests"), "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "--rootdir", ROOT],
        plugins=[outcomes],
    )
    log("F", f"card-only tests: {outcomes.counts}, rc={int(rc)}")
    check(int(rc) == 0, "card-only tests failed")
    check(outcomes.counts.get("passed", 0) > 0
          and not outcomes.counts.get("skipped"),
          "card-only tests did not run on the card")


def phase_four_cards(ctx: Ctx, per_card: int) -> None:
    """BASELINE config 5: a sharded f32 tensor over four cards."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import tpu_blosc as blosc
    from tpu_blosc.chunk import compress_chunked
    from tpu_blosc.dist.mesh import (
        block_mesh,
        compress_chunked_mesh,
        decompress_chunked_mesh,
    )
    from tpu_blosc.options import Options

    mesh = block_mesh(4)
    sharding = NamedSharding(mesh, P("blocks"))
    x = field(4 * per_card // 4, np.float32, ctx.seed + 5, sharding)
    check_on(ctx, x, "sharded input", n_devices=4)
    log("4", f"{x.nbytes / GiB:.3f} GiB f32 sharded over "
             f"{[str(d) for d in mesh.devices]}")
    opts = Options(type_size=4)
    frame = blosc.compress_array(x, opts)
    single = blosc.compress_array(jax.device_put(x, jax.devices()[0]), opts)
    check(frame == single, "sharded frame differs from the one-device frame")
    log("4", f"sharded compress_array frame ({len(frame)} B) equals the "
             "one-device frame")
    out = blosc.decompress_array(frame, np.float32, shape=x.shape,
                                 sharding=sharding)
    check_on(ctx, out, "sharded decode", n_devices=4)
    check(len({s.device for s in out.addressable_shards}) == 4,
          "decoded shards do not sit on 4 distinct devices")
    check(same_bits(out, x), "sharded decode differs")
    log("4", "decompress_array(sharding=...) bit-exact, shards on "
             f"{sorted(str(s.device) for s in out.addressable_shards)}")
    host = np.asarray(x).tobytes()
    on_mesh = compress_chunked_mesh(host, opts, mesh)
    check(on_mesh == compress_chunked(host, opts),
          "compress_chunked_mesh differs from compress_chunked")
    check(decompress_chunked_mesh(on_mesh, mesh) == host,
          "decompress_chunked_mesh did not round-trip")
    log("4", "compress_chunked_mesh == compress_chunked; "
             "decompress_chunked_mesh round-trips")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded phase")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    build_native()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)  # the f64 phase needs it
    from tpu_blosc.compile_cache import enable_compile_cache

    enable_compile_cache()
    n_cards = 4 if args.four_cards else 1
    ctx = phase_env("gpu", n_cards)
    ctx.seed = args.seed
    if args.four_cards:
        # a Blosc frame's size fields are 32-bit, so 4 x 1 GiB (2**32
        # bytes) cannot be one frame: cut each card's shard by 16 MiB
        per_card = GiB - 16 * MiB
        log("4", f"cut: {per_card // MiB} MiB per card instead of 1024 "
                 "(frame sizes are uint32)")
        phase_four_cards(ctx, per_card)
    else:
        phase_device_arrays(ctx)
        phase_checkpoint(ctx)
        phase_strategies(ctx)
        phase_kernel_times(ctx)
        phase_card_tests(ctx)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_cards if args.four_cards else len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
