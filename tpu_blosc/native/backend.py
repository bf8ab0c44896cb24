"""ctypes binding to the C++ host backend (libtpublosc.so).

Build contract: ``libtpublosc.so`` (from ``tpublosc.cpp``) and the
CPython fastcall module ``_tpbfast.so`` (from ``fastmod.c``) are compiled
from the tracked sources into ``build/<key>/`` next to this file, where
``<key>`` hashes the sources, the compiler flags, the machine, the CPU's
feature flags and the Python ABI.  A library built on another host (or
from other sources) therefore sits under another key and is never
loaded.  The build runs at first use, or ahead of time with the one
documented command::

    python -m tpu_blosc.native

which builds (if needed), prints the build record and exits non-zero
when the library is unavailable.  The build has a single attempt with a
single deadline (``BUILD_TIMEOUT_S``); a failure is reported with the
compiler's message (``build_info()``, and a RuntimeWarning) and callers
fall back to the pure-Python/NumPy paths — the same boolean-degradation
contract as the reference's SIMD dispatch (shuffle.go:31-57).

Beyond the single-buffer entry points (mirroring the reference's per-call
API), this exposes the whole-chunk block pipelines
(``compress_blocks``/``decompress_blocks``) that filter+compress every
block of a chunked frame in one call with OpenMP across blocks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import sysconfig
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tpublosc.cpp")
_FAST_SRC = os.path.join(_HERE, "fastmod.c")
_BUILD_ROOT = os.path.join(_HERE, "build")
# TPU_BLOSC_LIB: explicit path to a prebuilt library (sanitizer builds in
# CI, cross-build testing); when set, nothing is built and the fastcall
# module stays off.
_LIB_OVERRIDE = os.environ.get("TPU_BLOSC_LIB")

#: one deadline for the whole build (library + fastcall module), seconds
BUILD_TIMEOUT_S = 600

_lib = None
_fast = None  # CPython fastcall module (_tpbfast), see _load_fastmod
_lock = threading.Lock()
_tried = False
_build_info: dict = {}

_i64 = ctypes.c_int64
_p = ctypes.c_void_p


def _compile_flags() -> tuple[list[str], list[str]]:
    """(flags, extra include/lib paths) for this platform.

    Stock Apple clang (the macOS ``g++`` alias) rejects ``-march=native``
    and ``-fopenmp``; neither is required — every SIMD intrinsic and
    every OpenMP call in the source is #ifdef-gated, and the SpinPool
    needs no OpenMP — so darwin builds without them and adds the Homebrew
    prefixes, which Apple clang does not search by default."""
    base = ["-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17"]
    if sys.platform == "darwin":
        extra = []
        for pre in ("/opt/homebrew", "/usr/local"):
            if os.path.isdir(pre + "/include"):
                extra += ["-I" + pre + "/include", "-L" + pre + "/lib"]
        return base, extra
    return base + ["-march=native", "-fopenmp"], []


def _cpu_features() -> str:
    """The CPU's feature flags (x86 ``flags`` / arm ``Features`` line of
    /proc/cpuinfo); elsewhere the processor name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def build_key() -> str:
    """Hash of everything the built binaries depend on (see module doc)."""
    h = hashlib.sha256()
    for path in (_SRC, _FAST_SRC):
        with open(path, "rb") as f:
            h.update(f.read())
    flags, extra = _compile_flags()
    for part in (
        " ".join(flags + extra), sys.platform, platform.machine(),
        _cpu_features(), sysconfig.get_config_var("EXT_SUFFIX") or "",
    ):
        h.update(part.encode() + b"\0")
    return h.hexdigest()[:16]


def _run_compiler(cmd: list[str], out: str, deadline: float) -> None:
    """Run ``cmd`` (whose ``"{out}"`` element is the output path) into a
    private temp name and rename it into place, so concurrent processes
    never load a half-written file."""
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [c if c != "{out}" else tmp for c in cmd]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True,
            timeout=max(deadline - time.monotonic(), 1.0),
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build(build_dir: str) -> None:
    """Build both binaries into ``build_dir`` (skipping what exists).

    Raises on failure.  A file lock serialises concurrent builds (test
    workers importing the package at once); the loser finds the files."""
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, "libtpublosc.so")
    fast_path = os.path.join(build_dir, "_tpbfast.so")
    flags, extra = _compile_flags()
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-POSIX
        fcntl = None
    with open(build_dir + ".lock", "w") as lock:
        if fcntl is not None:
            fcntl.flock(lock, fcntl.LOCK_EX)
        t0 = time.monotonic()
        if not os.path.exists(lib_path):
            _run_compiler(
                ["g++"] + flags + extra + [_SRC, "-o", "{out}", "-lz"],
                lib_path, deadline,
            )
        if not os.path.exists(fast_path):
            # optional: without it the ctypes entry points serve every call
            try:
                _run_compiler(
                    ["gcc", "-O2", "-shared", "-fPIC",
                     "-I", sysconfig.get_paths()["include"], _FAST_SRC,
                     "-o", "{out}", "-L", build_dir, "-ltpublosc",
                     "-Wl,-rpath,$ORIGIN"],
                    fast_path, deadline,
                )
            except (OSError, subprocess.SubprocessError) as exc:
                msg = getattr(exc, "stderr", None) or str(exc)
                _build_info["fastmod_error"] = msg[-2000:]
        _build_info["build_seconds"] = round(time.monotonic() - t0, 3)


def build_info() -> dict:
    """Where the native library came from: path, build key, flags, build
    time, or the error that kept it from loading."""
    available()
    return dict(_build_info)


def _load() -> None:
    global _lib, _tried
    with _lock:
        if _tried:
            return
        _tried = True
        if os.environ.get("TPU_BLOSC_NO_NATIVE"):
            _build_info["error"] = "disabled by TPU_BLOSC_NO_NATIVE"
            return
        if _LIB_OVERRIDE:
            lib_path = _LIB_OVERRIDE
            _build_info.update(path=lib_path, flags="prebuilt (TPU_BLOSC_LIB)")
        else:
            key = build_key()
            build_dir = os.path.join(_BUILD_ROOT, key)
            lib_path = os.path.join(build_dir, "libtpublosc.so")
            flags, extra = _compile_flags()
            _build_info.update(
                path=lib_path, key=key, flags=" ".join(flags + extra)
            )
            try:
                _build(build_dir)
            except (OSError, subprocess.SubprocessError) as exc:
                msg = getattr(exc, "stderr", None) or str(exc)
                _build_info["error"] = f"native build failed: {msg[-2000:]}"
                import warnings

                warnings.warn(
                    "tpu_blosc: " + _build_info["error"]
                    + " — using the pure-Python codecs",
                    RuntimeWarning, stacklevel=3,
                )
                return
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError as exc:
            _build_info["error"] = f"load failed: {exc}"
            return
        for name in ("tpb_lz4_compress",):
            fn = getattr(lib, name)
            fn.restype = _i64
            fn.argtypes = [_p, _i64, _p, _i64, ctypes.c_int]
        for name in (
            "tpb_lz4_decompress",
            "tpb_snappy_compress",
            "tpb_snappy_decompress",
            "tpb_blosclz_compress",
            "tpb_blosclz_decompress",
        ):
            fn = getattr(lib, name)
            fn.restype = _i64
            fn.argtypes = [_p, _i64, _p, _i64]
        for name in (
            "tpb_shuffle",
            "tpb_unshuffle",
            "tpb_bitshuffle",
            "tpb_bitunshuffle",
        ):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [_p, _p, _i64, ctypes.c_int]
        lib.tpb_compress_blocks.restype = _i64
        lib.tpb_compress_blocks.argtypes = [
            _p, _i64, _i64,                       # src, n, block_size
            ctypes.c_int, ctypes.c_int,           # ts, shuffle_mode
            ctypes.c_int, ctypes.c_int,           # codec, depth
            _p, _i64,                             # out, slot_stride
            _p, _p,                               # out_sizes, out_memcpy
            ctypes.c_int,                         # num_threads (0 = default)
        ]
        lib.tpb_decompress_blocks.restype = _i64
        lib.tpb_decompress_blocks.argtypes = [
            _p, _p, _p, _p,                       # payloads, offsets, psizes, is_memcpy
            _i64, _i64, _i64,                     # nb, block_size, total_n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ts, shuffle_mode, codec
            _p,                                   # out
            ctypes.c_int,                         # num_threads (0 = default)
        ]
        lib.tpb_compress_bound.restype = _i64
        lib.tpb_compress_bound.argtypes = [_i64, ctypes.c_int]
        lib.tpb_num_threads.restype = ctypes.c_int
        lib.tpb_num_threads.argtypes = []
        lib.tpb_gather.restype = _i64
        lib.tpb_gather.argtypes = [_p, _p, _i64, _i64, _p]
        lib.tpb_lz4_emit_runs.restype = _i64
        lib.tpb_lz4_emit_runs.argtypes = [_p, _p, _i64, _i64, _p, _i64]
        lib.tpb_lz4_emit_mixed.restype = _i64
        lib.tpb_lz4_emit_mixed.argtypes = [
            _p, _p, _i64,                         # lit_pos, lit_bytes, nlit
            _p, _i64, _i64,                       # row_d, seg, n
            _p, _i64,                             # dst, cap
        ]
        lib.tpb_mask_positions.restype = _i64
        lib.tpb_mask_positions.argtypes = [_p, _i64, _p, _i64]
        lib.tpb_set_num_threads.restype = None
        lib.tpb_set_num_threads.argtypes = [ctypes.c_int]
        # c_char_p lets the hot single-shot paths pass bytes objects with
        # zero wrapping (no numpy view, no pointer object churn)
        lib.tpb_compress_frame.restype = _i64
        lib.tpb_compress_frame.argtypes = [
            ctypes.c_char_p, _i64,                # src (bytes), n
            ctypes.c_int, ctypes.c_int,           # ts, shuffle_mode
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # header_codec, codec, depth
            _p,                                   # dst (16 + bound)
        ]
        lib.tpb_decompress_block_into.restype = _i64
        lib.tpb_decompress_block_into.argtypes = [
            ctypes.c_char_p, _i64, _i64,          # frame (bytes), payload_off, psize
            _p, _i64,                             # out, n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # ts, shuffle_mode, codec
        ]
        lib.tpb_zstd_available.restype = ctypes.c_int
        lib.tpb_zstd_available.argtypes = []
        lib.tpb_zstd_compress.restype = _i64
        lib.tpb_zstd_compress.argtypes = [_p, _i64, _p, _i64, ctypes.c_int]
        lib.tpb_zstd_decompress.restype = _i64
        lib.tpb_zstd_decompress.argtypes = [_p, _i64, _p, _i64]
        _lib = lib
        _load_fastmod(os.path.dirname(lib_path))


def _load_fastmod(build_dir: str) -> None:
    """Import the CPython fastcall module (_tpbfast) when it was built.

    The module links against libtpublosc.so (rpath $ORIGIN) and cuts the
    per-call ctypes marshalling + staging memmove from the single-block
    hot path.  Without it (build failure, sanitizer override build,
    TPU_BLOSC_NO_FAST) the ctypes path serves every call.
    """
    global _fast
    if _LIB_OVERRIDE or os.environ.get("TPU_BLOSC_NO_FAST"):
        return
    out = os.path.join(build_dir, "_tpbfast.so")
    if not os.path.exists(out):
        return
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "tpu_blosc.native._tpbfast", out
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _fast = mod
    except Exception:
        _fast = None
    _build_info["fastcall"] = _fast is not None


def available() -> bool:
    if not _tried:
        _load()
    return _lib is not None


def num_threads() -> int:
    return _lib.tpb_num_threads() if available() else 1


def _ensure() -> None:
    if not available():
        raise RuntimeError("native backend unavailable")


def zstd_available() -> bool:
    """Whether the runtime found a loadable libzstd (it is dlopen'd)."""
    return available() and bool(_lib.tpb_zstd_available())


# Uninitialized-bytes allocation via the CPython C API: native kernels
# write straight into the result object's buffer (the pattern C extensions
# use with PyBytes_FromStringAndSize(NULL, n)), eliminating the extra
# n-byte copy a numpy->tobytes round trip would cost.  The object is
# exclusively owned until returned, so the write-before-expose is safe.
_pybytes_new = ctypes.pythonapi.PyBytes_FromStringAndSize
_pybytes_new.restype = ctypes.py_object
_pybytes_new.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
_pybytes_addr = ctypes.pythonapi.PyBytes_AsString
_pybytes_addr.restype = _p
_pybytes_addr.argtypes = [ctypes.py_object]


def alloc_bytes(n: int) -> tuple[bytes, int]:
    """Return (uninitialized bytes object of length n, writable address)."""
    b = _pybytes_new(None, n)
    return b, _pybytes_addr(b)


def set_num_threads(n: int) -> None:
    """Cap the OpenMP team (≙ Options.NumThreads, reference blosc.go:233)."""
    if available() and n > 0:
        _lib.tpb_set_num_threads(n)


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        a = data.reshape(-1).view(np.uint8)
        return a if a.flags.c_contiguous else np.ascontiguousarray(a)
    return np.frombuffer(data, dtype=np.uint8)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_p)


# ---------------------------------------------------------------------------
# single-buffer codec entry points
# ---------------------------------------------------------------------------


def lz4_compress(data, depth: int = 1) -> bytes:
    _ensure()
    a = _as_u8(data)
    n = a.size
    cap = n + n // 255 + 16
    out = np.empty(cap, dtype=np.uint8)
    written = _lib.tpb_lz4_compress(_ptr(a), n, _ptr(out), cap, depth)
    if written < 0:
        raise RuntimeError(f"native lz4 compress failed ({written})")
    return out[:written].tobytes()


def lz4_decompress(data, expected_size: int) -> bytes:
    _ensure()
    from ..errors import DecompressionFailedError

    a = _as_u8(data)
    out, addr = alloc_bytes(expected_size)
    written = _lib.tpb_lz4_decompress(_ptr(a), a.size, addr, expected_size)
    if written < 0:
        raise DecompressionFailedError(f"lz4: malformed stream (code {written})")
    return out if written == expected_size else out[:written]


def blosclz_compress(data) -> bytes:
    _ensure()
    a = _as_u8(data)
    n = a.size
    cap = n + n // 32 + 16
    out = np.empty(cap, dtype=np.uint8)
    written = _lib.tpb_blosclz_compress(_ptr(a), n, _ptr(out), cap)
    if written < 0:
        raise RuntimeError(f"native blosclz compress failed ({written})")
    return out[:written].tobytes()


def blosclz_decompress(data, expected_size: int) -> bytes:
    _ensure()
    from ..errors import DecompressionFailedError

    a = _as_u8(data)
    out, addr = alloc_bytes(expected_size)
    written = _lib.tpb_blosclz_decompress(_ptr(a), a.size, addr, expected_size)
    if written < 0:
        raise DecompressionFailedError(
            f"blosclz: malformed stream (code {written})"
        )
    return out if written == expected_size else out[:written]


def snappy_compress(data) -> bytes:
    _ensure()
    a = _as_u8(data)
    n = a.size
    cap = 32 + n + n // 6
    out = np.empty(cap, dtype=np.uint8)
    written = _lib.tpb_snappy_compress(_ptr(a), n, _ptr(out), cap)
    if written < 0:
        raise RuntimeError(f"native snappy compress failed ({written})")
    return out[:written].tobytes()


def snappy_decompress(data, expected_size: int) -> bytes:
    _ensure()
    from ..errors import DecompressionFailedError

    a = _as_u8(data)
    out, addr = alloc_bytes(expected_size)
    written = _lib.tpb_snappy_decompress(_ptr(a), a.size, addr, expected_size)
    if written < 0:
        raise DecompressionFailedError(
            f"snappy: malformed stream (code {written})"
        )
    return out if written == expected_size else out[:written]


def zstd_compress(data, level: int) -> bytes:
    """One zstd frame at the given zstd library level."""
    _ensure()
    a = _as_u8(data)
    cap = int(_lib.tpb_compress_bound(a.size, NATIVE_ZSTD))
    out = np.empty(cap, dtype=np.uint8)
    written = _lib.tpb_zstd_compress(_ptr(a), a.size, _ptr(out), cap, level)
    if written < 0:
        raise RuntimeError(f"native zstd compress failed ({written})")
    return out[:written].tobytes()


def zstd_decompress(data, expected_size: int) -> bytes:
    """Decode one or more concatenated zstd frames into at most
    ``expected_size`` bytes (more content is a malformed stream)."""
    _ensure()
    from ..errors import DecompressionFailedError

    a = _as_u8(data)
    out, addr = alloc_bytes(expected_size)
    written = _lib.tpb_zstd_decompress(_ptr(a), a.size, addr, expected_size)
    if written < 0:
        raise DecompressionFailedError(f"zstd: malformed stream (code {written})")
    return out if written == expected_size else out[:written]


def lz4_emit_runs(vals: np.ndarray, lens: np.ndarray, n: int) -> bytes:
    """Emit a standard LZ4 block stream from (value, length) run records.

    The device-RLE encoder's host half: O(runs) work, decodes everywhere.
    """
    _ensure()
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    cap = n + n // 255 + 16
    out = np.empty(cap, dtype=np.uint8)
    written = _lib.tpb_lz4_emit_runs(
        _ptr(vals), _ptr(lens), vals.size, n, _ptr(out), cap
    )
    if written < 0:
        raise RuntimeError(f"lz4_emit_runs failed ({written})")
    return out[:written].tobytes()


def lz4_emit_mixed(
    lit_pos: np.ndarray,
    lit_bytes: np.ndarray,
    row_d: np.ndarray,
    seg: int,
    n: int,
    cap: int | None = None,
) -> bytes | None:
    """Emit a standard LZ4 stream from fixed-offset match records.

    The device match-discovery encoder's host half: ``lit_pos``/``lit_bytes``
    are the block's literal positions (sorted) and values; every other byte
    of row r is a match at offset ``row_d[r]``.  O(records) work; the
    stream decodes with any LZ4 block decoder.  Returns None when the
    emitted stream would exceed ``cap`` (caller falls back to re-encoding).
    """
    _ensure()
    lit_pos = np.ascontiguousarray(lit_pos, dtype=np.int64)
    lit_bytes = np.ascontiguousarray(lit_bytes, dtype=np.uint8)
    row_d = np.ascontiguousarray(row_d, dtype=np.int32)
    if cap is None:
        cap = n + n // 255 + 16
    out = np.empty(cap, dtype=np.uint8)
    written = _lib.tpb_lz4_emit_mixed(
        _ptr(lit_pos), _ptr(lit_bytes), lit_pos.size,
        _ptr(row_d), seg, n, _ptr(out), cap,
    )
    if written == -1:
        return None
    if written < 0:
        raise RuntimeError(f"lz4_emit_mixed failed ({written})")
    return out[:written].tobytes()


def mask_positions(mask: np.ndarray, nset: int) -> np.ndarray | None:
    """Set-bit positions (sorted, int32) of a little-endian packed mask.

    ``nset`` is the expected popcount (the device pipeline already has it
    from the per-segment literal counts), so the output is allocated
    exactly and the C scan never reallocates.  Returns None when the mask
    holds MORE set bits than ``nset`` (device/host disagreement — callers
    bail to the transfer path).  ~20x the NumPy unpackbits formulation on
    multi-MiB masks (ctz word scan vs byte-expand).
    """
    _ensure()
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty(nset, dtype=np.int32)
    k = _lib.tpb_mask_positions(_ptr(mask), mask.size, _ptr(out), nset)
    if k < 0:
        return None
    return out[:k]


# ---------------------------------------------------------------------------
# shuffle filter entry points
# ---------------------------------------------------------------------------


def _shuffle_call(name: str, data, type_size: int) -> np.ndarray:
    _ensure()
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    getattr(_lib, name)(_ptr(a), _ptr(out), a.size, type_size)
    return out


def shuffle(data, type_size: int) -> np.ndarray:
    return _shuffle_call("tpb_shuffle", data, type_size)


def unshuffle(data, type_size: int) -> np.ndarray:
    return _shuffle_call("tpb_unshuffle", data, type_size)


def bitshuffle(data, type_size: int) -> np.ndarray:
    return _shuffle_call("tpb_bitshuffle", data, type_size)


def bitunshuffle(data, type_size: int) -> np.ndarray:
    return _shuffle_call("tpb_bitunshuffle", data, type_size)


# ---------------------------------------------------------------------------
# whole-chunk block pipelines
# ---------------------------------------------------------------------------

# codec IDs of the native pipeline (NOT the frame codec byte; mapping is in
# chunk.py): 0 = BloscLZ, 1 = LZ4 (depth 1), 2 = LZ4HC (depth>1), 3 = Snappy
NATIVE_BLOSCLZ = 0
NATIVE_LZ4 = 1
NATIVE_LZ4HC = 2
NATIVE_SNAPPY = 3
NATIVE_ZLIB = 4
NATIVE_ZSTD = 5


def compress_blocks(
    data,
    block_size: int,
    type_size: int,
    shuffle_mode: int,
    native_codec: int,
    depth: int,
    num_threads: int = 0,
) -> tuple[list[bytes], list[bool]]:
    """Filter+compress every block of ``data`` in one parallel native call.

    Returns (payloads, is_memcpy) per block, mirroring the per-block logic
    of chunk.compress_chunked.  ``num_threads`` > 0 caps the OpenMP team
    for this call (Options.num_threads; ≙ the knob blosc.go:233 reserves).
    """
    _ensure()
    a = _as_u8(data)
    n = a.size
    nb = -(-n // block_size)
    slot = int(_lib.tpb_compress_bound(block_size, native_codec))
    out = np.empty(nb * slot, dtype=np.uint8)
    sizes = np.empty(nb, dtype=np.int64)
    memcpy_flags = np.empty(nb, dtype=np.uint8)
    rc = _lib.tpb_compress_blocks(
        _ptr(a), n, block_size,
        type_size, shuffle_mode, native_codec, depth,
        _ptr(out), slot, _ptr(sizes), _ptr(memcpy_flags),
        num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native compress_blocks failed ({rc})")
    payloads = [
        out[i * slot : i * slot + sizes[i]].tobytes() for i in range(nb)
    ]
    return payloads, [bool(f) for f in memcpy_flags]


def compress_blocks_frame(
    data,
    block_size: int,
    type_size: int,
    shuffle_mode: int,
    native_codec: int,
    depth: int,
    header_table_builder,
    num_threads: int = 0,
) -> bytes:
    """Filter+compress all blocks AND assemble the frame with one payload copy.

    ``header_table_builder(sizes, memcpy_flags) -> bytes`` produces the
    16-byte header + block table; payloads are gathered natively straight
    into the result bytes object.
    """
    _ensure()
    a = _as_u8(data)
    n = a.size
    nb = -(-n // block_size)
    slot = int(_lib.tpb_compress_bound(block_size, native_codec))
    out = np.empty(nb * slot, dtype=np.uint8)
    sizes = np.empty(nb, dtype=np.int64)
    memcpy_flags = np.empty(nb, dtype=np.uint8)
    rc = _lib.tpb_compress_blocks(
        _ptr(a), n, block_size,
        type_size, shuffle_mode, native_codec, depth,
        _ptr(out), slot, _ptr(sizes), _ptr(memcpy_flags),
        num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native compress_blocks failed ({rc})")
    prefix = header_table_builder(sizes, memcpy_flags)
    total = len(prefix) + int(sizes.sum())
    frame, addr = alloc_bytes(total)
    ctypes.memmove(addr, prefix, len(prefix))
    rc = _lib.tpb_gather(_ptr(out), _ptr(sizes), nb, slot, addr + len(prefix))
    if rc != 0:
        raise MemoryError("native frame gather failed: offsets allocation")
    return frame


def decompress_blocks(
    payloads: np.ndarray,
    offsets: np.ndarray,
    psizes: np.ndarray,
    is_memcpy: np.ndarray,
    block_size: int,
    total_n: int,
    type_size: int,
    shuffle_mode: int,
    native_codec: int,
    out_addr: int | None = None,
    num_threads: int = 0,
) -> bytes | None:
    """Decompress+unfilter every block in one parallel native call.

    Writes straight into the returned bytes object — no intermediate copy.
    With ``out_addr`` set, writes to the caller's buffer instead and
    returns the byte count (the decompress_into path).
    """
    _ensure()
    from ..errors import DecompressionFailedError

    nb = offsets.size
    if out_addr is None:
        out, addr = alloc_bytes(total_n)
    else:
        out, addr = None, out_addr
    got = _lib.tpb_decompress_blocks(
        _ptr(payloads), _ptr(offsets), _ptr(psizes), _ptr(is_memcpy),
        nb, block_size, total_n,
        type_size, shuffle_mode, native_codec,
        addr,
        num_threads,
    )
    if got != total_n:
        raise DecompressionFailedError(
            f"native decompress_blocks failed (code {got})"
        )
    return out if out_addr is None else total_n


_frame_scratch = threading.local()


def _staging_addr(nbytes: int) -> int:
    """Address of a per-thread staging buffer (grows, never moves mid-call)."""
    t = _frame_scratch
    if getattr(t, "cap", 0) < nbytes:
        buf = np.empty(max(nbytes, 1 << 17), dtype=np.uint8)
        t.buf = buf
        t.cap = buf.size
        t.addr = buf.ctypes.data
    return t.addr


# conservative superset of codec_bound() for every native codec (lz4 n/255,
# snappy n/6, zlib n/4096, zstd n/128 — all + small constants); lets the
# hot path skip a ctypes call to tpb_compress_bound
def _universal_bound(n: int) -> int:
    return 16 + n + (n >> 2) + 1024


def compress_frame(
    data: bytes,
    type_size: int,
    shuffle_mode: int,
    header_codec: int,
    native_codec: int,
    depth: int,
) -> bytes:
    """One C call producing a complete single-block frame (header included).

    The single-shot analogue of compressBackend (blosc.go:319-374): filter,
    codec, memcpy fallback, and header assembly all happen inside
    tpb_compress_frame — one ctypes crossing instead of four, which is what
    the reference's own 100 KB benchmark point is sensitive to.  ``data``
    must be a bytes object (passed zero-copy via c_char_p).
    """
    if _fast is not None:
        return _fast.compress_frame(
            data, type_size, shuffle_mode, header_codec, native_codec, depth
        )
    if not isinstance(data, bytes):  # ctypes c_char_p needs a bytes object
        data = bytes(data)
    n = len(data)
    dst = _staging_addr(_universal_bound(n))
    total = _lib.tpb_compress_frame(
        data, n, type_size, shuffle_mode, header_codec, native_codec,
        depth, dst,
    )
    if total < 0:
        raise RuntimeError(f"native compress_frame failed ({total})")
    out, addr = alloc_bytes(total)
    ctypes.memmove(addr, dst, total)
    return out


def compress_frames(
    items,
    type_size: int,
    shuffle_mode: int,
    header_codec: int,
    native_codec: int,
    depth: int,
) -> list:
    """Batch compress_frame: one binding crossing for N frames.

    With the fastcall module present, the native side runs whole small
    frames (< the segment-parallel floor) across the SpinPool and larger
    frames through their normal internally-parallel path, so output bytes
    are identical to per-item compress_frame at every size.  Without it,
    a scalar loop provides the same results.
    """
    if _fast is not None and hasattr(_fast, "compress_batch"):
        return _fast.compress_batch(
            items, type_size, shuffle_mode, header_codec, native_codec, depth
        )
    return [
        compress_frame(d if isinstance(d, bytes) else bytes(d), type_size,
                       shuffle_mode, header_codec, native_codec, depth)
        for d in items
    ]


def decompress_frames(items, type_size: int, native_map: bytes) -> list:
    """Batch single-block frame decode; None entries mean "not handled".

    native_map[codec_id] is the native codec id for header byte 1, 0xFF
    when that id must take the Python path (unknown / user-overridden /
    native unavailable).  Items that are not plain single-block frames,
    or whose payload fails to decode, come back as None — the caller
    re-runs those through the scalar path, which owns every typed error.
    """
    if _fast is not None and hasattr(_fast, "decompress_batch"):
        return _fast.decompress_batch(items, type_size, native_map)
    return [None] * len(items)


def decompress_frames_into(items, outs, native_map: bytes) -> list:
    """Batch decode into caller buffers; entries are byte counts or None.

    The zero-copy sibling of decompress_frames: eligible frames decode
    straight into ``outs[i]`` (writable, >= the frame's NBytesOrig).
    None entries punt to the scalar path exactly like decompress_frames.
    """
    if _fast is not None and hasattr(_fast, "decompress_batch_into"):
        return _fast.decompress_batch_into(items, outs, 0, native_map)
    return [None] * len(items)


def decompress_frame(
    data: bytes,
    payload_off: int,
    payload_size: int,
    nbytes_orig: int,
    type_size: int,
    shuffle_mode: int,
    native_codec: int,
) -> bytes:
    """One C call decoding + unfiltering a single-block frame body.

    Writes straight into the returned bytes object.  Raises
    DecompressionFailedError on malformed payloads and SizeMismatchError
    when the payload decodes cleanly to the wrong size (parity with the
    final check at blosc.go:429-431).
    """
    if _fast is not None:
        res = _fast.decompress_frame(
            data, payload_off, payload_size, nbytes_orig,
            type_size, shuffle_mode, native_codec,
        )
        if isinstance(res, bytes):
            return res
        got = res
    else:
        out, addr = alloc_bytes(nbytes_orig)
        got = _lib.tpb_decompress_block_into(
            data, payload_off, payload_size,
            addr, nbytes_orig,
            type_size, shuffle_mode, native_codec,
        )
        if got == nbytes_orig:
            return out
    from ..errors import DecompressionFailedError, SizeMismatchError

    if got < 0:
        raise DecompressionFailedError(
            f"blosc: decompression failed: malformed payload (code {got})"
        )
    raise SizeMismatchError(
        f"blosc: decompressed size mismatch: got {got}, "
        f"expected {nbytes_orig}"
    )
