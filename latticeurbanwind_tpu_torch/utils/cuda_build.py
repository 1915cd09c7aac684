"""Build and load the port's CUDA kernels (nvcc + ctypes).

The `.cu` sources under `latticeurbanwind_tpu_torch/csrc/` are compiled on
first use into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libluwtorch_<sha256>.so csrc/*.cu

The file name carries the SHA-256 of the sources, so an edited kernel
rebuilds and an unchanged one loads the existing library.  A missing nvcc
or a failed build raises with nvcc's output; nothing falls back.  Nothing
here runs at import time: the CPU tests import every module and never build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument types of every C entry point: pointers and the stream as void*
SIGNATURES = {
    # fa, fb, flags, dyn, nudge_sigma, nudge_face, uw, ue, us, un, ut, ub,
    # sponge_z, Z, Y, X, storage, volume_force, has_nudge, has_sponge,
    # nudge_vertical, subgrid, omega, tau0, tau0_sq, stream
    "luw_stream_collide": [_P] * 13 + [_I] * 9 + [_F] * 3 + [_P],
    # fi, flags, dyn, inv_n, mean_u, m2_u, mean_rho, Z, Y, X, storage, stream
    "luw_avg_update": [_P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def build() -> tuple[Path, str]:
    """(library path, nvcc's output) — builds only when the library for the
    current sources does not exist yet; the output is then the build log."""
    lib = BUILD_DIR / f"libluwtorch_{source_digest()}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)          # atomic: a reader never sees half a file
    return lib, out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with every entry
    point's argument types declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
