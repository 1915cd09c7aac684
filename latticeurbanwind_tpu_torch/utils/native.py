"""Loader for the native C++ runtime library (ctypes, built on demand).

Compiles native/luwnative.cpp with the system g++ on first use and caches the
shared object next to the source.  Every consumer has a pure-numpy fallback,
so environments without a toolchain still work.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "luwnative.cpp"
_LIB = _SRC.with_name("libluwnative.so")
_STAMP = _SRC.with_name(".luwnative.sha256")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _src_digest() -> str:
    return hashlib.sha256(_SRC.read_bytes()).hexdigest()


def _build(digest: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
             "-o", str(_LIB), str(_SRC), "-lpthread"],
            check=True, capture_output=True, timeout=240,
        )
        _STAMP.write_text(digest)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        print(f"[native] build failed, using numpy fallbacks: {e}")
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    # Rebuild whenever the .so is absent or the recorded source hash differs —
    # never trust a pre-existing binary on mtime alone (fresh checkouts give
    # source and binary identical mtimes).
    digest = _src_digest()
    stamp = _STAMP.read_text().strip() if _STAMP.exists() else ""
    if not _LIB.exists() or stamp != digest:
        if not _build(digest):
            if _LIB.exists():
                # toolchain-less host with a pre-existing binary: use it but
                # say so — it may lag the current source
                print("[native] rebuild unavailable; loading the existing "
                      f"{_LIB.name} (may predate {_SRC.name})")
            else:
                return None
    try:
        lib = ctypes.CDLL(str(_LIB))
        # a pre-existing stale binary may lack newer symbols: probe before
        # typing, and let the numpy fallbacks cover anything missing
        for sym in ("voxelize_columns", "encode_be_f32_aos"):
            if not hasattr(lib, sym):
                print(f"[native] {_LIB.name} lacks {sym}; numpy fallback")
                return None
        lib.voxelize_columns.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.encode_be_f32_aos.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        if hasattr(lib, "parse_csv_doubles"):
            lib.parse_csv_doubles.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.parse_csv_doubles.restype = ctypes.c_int64
        _lib = lib
    except (OSError, AttributeError) as e:
        print(f"[native] load failed, using numpy fallbacks: {e}")
    return _lib


def voxelize_columns_native(tris: np.ndarray, shape, jitter: float = 1e-4
                            ) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    Z, Y, X = shape
    tris64 = np.ascontiguousarray(tris, dtype=np.float64)
    out = np.zeros((Z, Y, X), dtype=np.uint8)
    lib.voxelize_columns(
        tris64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(tris64)),
        ctypes.c_int64(Z), ctypes.c_int64(Y), ctypes.c_int64(X),
        ctypes.c_double(jitter),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def parse_csv_native(text: bytes, max_cols: int = 16) -> Optional[np.ndarray]:
    """Numeric CSV body -> (rows, n_cols) float64 with NaN blanks, or None.

    ~20x the throughput of Python-level split/float loops on production
    SurfData files (reference read_samples scale, setup.cpp:2291-2440)."""
    lib = load()
    if lib is None or not hasattr(lib, "parse_csv_doubles"):
        return None
    # count both line-ending styles (CR-only files still split on \r in C)
    max_rows = text.count(b"\n") + text.count(b"\r") + 2
    out = np.empty((max_rows, max_cols), dtype=np.float64)
    ncols = ctypes.c_int64(0)
    n = lib.parse_csv_doubles(
        text, ctypes.c_int64(len(text)), ctypes.c_int64(max_cols),
        ctypes.c_int64(max_rows),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(ncols))
    if n <= 0:
        return None
    return out[:n, :max(ncols.value, 1)]


def encode_be_f32_aos_native(planes: np.ndarray) -> Optional[bytes]:
    """(C, N) float32 SoA -> big-endian AoS bytes, single native pass."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(planes, dtype=np.float32)
    comp, n = src.shape
    dst = np.empty(n * comp, dtype=np.float32)
    lib.encode_be_f32_aos(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int64(comp),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return dst.tobytes()
