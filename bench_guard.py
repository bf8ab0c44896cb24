"""Benchmark regression guard (VERDICT r1 item 8): fail CI on collapse.

Reads the single JSON line bench.py prints (from stdin or a file argument)
and checks it against committed floor thresholds.  The floors are
deliberately generous — the shared 4-core VM varies ±30-40% run-to-run and
CI runners differ from the dev host — so this catches structural
regressions (native backend silently disabled, a pipeline falling back to
pure Python, ratio collapse), not noise.

Usage:
    python bench.py | python bench_guard.py
    python bench_guard.py BENCH_r02.json
"""

from __future__ import annotations

import json
import sys

# floor thresholds: ~4-5x below typical measurements on the dev host so
# only order-of-magnitude collapses trip them (pure-Python fallback runs
# at ~0.05 GB/s — two orders below these floors)
FLOORS = {
    "value": 3.0,              # compress GB/s (typical 13-20)
    "decompress_gbps": 3.0,    # typical 13-17
    "ratio": 50.0,             # typical ~137 on the 64 MiB f32 ramp
    # segment-parallel single-block path (round 3): typical 12-17 / 19-22;
    # a collapse to the serial path reads ~9 / ~7
    "single_block_1mib_compress_gbps": 3.0,
    "single_block_1mib_decompress_gbps": 3.0,
    # ts=2 single-block (round-4 fused plane extraction): typical 22-27
    # compress; a collapse to the two-stage path reads ~12-18
    "single_block_1mib_ts2_compress_gbps": 5.0,
    "single_block_1mib_ts2_decompress_gbps": 3.0,
    # BloscLZ (codec 0): typical 17-23 / 15-20 on the same shape; the
    # pure-Python oracle fallback reads ~0.01 — this floor catches the
    # native path silently dropping out for the sixth codec
    "blosclz_1mib_compress_gbps": 3.0,
    "blosclz_1mib_decompress_gbps": 3.0,
    "zlib_1mib_compress_gbps": 0.7,    # typical 1.1-1.25 (round-4 ld path)
    "zlib_1mib_decompress_gbps": 1.5,  # typical 3+ (libdeflate inflate)
    # round 5: every registry codec gets a guarded metric (VERDICT r4
    # missing #3 — a Snappy/ZSTD path collapse passed CI before this)
    "snappy_1mib_compress_gbps": 3.0,   # typical 14-17 (segment-parallel)
    "snappy_1mib_decompress_gbps": 2.5,  # typical 9-13 (parallel body scan)
    "zstd_1mib_compress_gbps": 0.25,    # typical 0.75-1 (serial; see
                                        # BASELINE ZSTD margin note)
    "zstd_1mib_decompress_gbps": 1.5,   # typical 4.5-5
    "lz4hc_1mib_compress_gbps": 2.5,    # typical 12-14 on the ramp shape
    "lz4hc_1mib_decompress_gbps": 3.0,  # typical 11-12
    # 16 MiB f32 bitshuffle (BASELINE config 4): typical 7.5-11.3 / 12-13
    # via the fixed-offset scan encoder; a collapse to greedy-only reads
    # ~2.9 compress
    "bitshuffle_16mib_f32_compress_gbps": 3.0,
    "bitshuffle_16mib_f32_decompress_gbps": 3.0,
    # batch API over 64x100 KB frames (round 3): whole-frame SpinPool
    # slices read ~25-31 / 18-24; a collapse to the scalar loop reads
    # ~7-10 both ways
    "batch_100kb_compress_gbps": 5.0,
    "batch_100kb_decompress_gbps": 5.0,
    # scalar 100 KB (the reference's own benchmark point): compress
    # typical 14-22 via the fused plane-parallel encode + the compress()
    # fast lane; decompress typical 13-17 via the round-5 fused
    # decode+unshuffle dispatch (floor raised from 4.0 per the r4
    # verdict); a collapse to the serial paths reads ~7-10 both ways
    "scalar_100kb_compress_gbps": 5.0,
    "scalar_100kb_decompress_gbps": 6.0,
}

def main() -> int:
    text = (
        open(sys.argv[1]).read() if len(sys.argv) > 1 else sys.stdin.read()
    )
    line = next(
        (ln for ln in text.strip().splitlines() if ln.lstrip().startswith("{")),
        None,
    )
    if line is None:
        print("bench_guard: no JSON line found in input", file=sys.stderr)
        return 2
    record = json.loads(line)
    print(line)  # pass the record through for the driver/CI log
    failures = []
    # host floors only: the device floors are set again from the first
    # H100 measurements, not carried over from another accelerator
    for key, floor in FLOORS.items():
        got = record.get(key)
        if got is None:
            failures.append(f"{key}: missing from bench output")
        elif float(got) < floor:
            failures.append(f"{key}: {got} < floor {floor}")
    if record.get("backend") not in ("native", "jax"):
        failures.append(f"backend degraded to {record.get('backend')!r}")
    if failures:
        print("bench_guard FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    print("bench_guard ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
