"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources under `latticeurbanwind_tpu_torch/csrc/` are compiled on first
use into one shared library with a plain C interface.  Every `.cu` file is
one translation unit, compiled by its own nvcc process, all started
together; the shared headers (`.cuh`) are only included:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -I csrc -c -o _build/<digest>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libluwtorch_<digest>.so _build/<digest>/*.o

The digest is the SHA-256 of every `.cu` and `.cuh`, so an edited kernel or
header rebuilds and an unchanged tree loads the existing library.  Extra
compile flags come from $LUW_NVCC_FLAGS (split on whitespace; each flag and
the content of each flag that names a file enter the digest): a variant of a
compile-time choice is built that way without editing the sources, e.g.
`-include variant.h` that sets the tiled body's shapes (chip_sweep.py).  The
build log (nvcc's output, `-Xptxas -v` included) ends each command's part
with a line `# nvcc <source name or link>: <seconds> s`.  A missing
nvcc or a failed build raises with nvcc's output; nothing falls back.
Nothing here runs at import time: the CPU tests import every module and
never build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argument types of every C entry point: pointers and the stream as void*
SIGNATURES = {
    # fa, fb, flags, dyn, nudge_sigma, nudge_face, uw, ue, us, un, ut, ub,
    # sponge_z, mask_uw, mask_ue, mask_us, mask_un, mask_ut, mask_ub, ga, gb,
    # tt, Z, Y, X, storage, volume_force, has_nudge, has_sponge,
    # nudge_vertical, subgrid, omega, tau0, tau0_sq, wall, trt, wall_cd,
    # wall_cd_sides, thermal, omega_t, beta, t_avg, fp_halo, fm_halo,
    # fp_stride, fm_stride, flb, fla, gp_halo, gm_halo, gy, gx, stream
    "luw_stream_collide": [_P] * 22 + [_I] * 9 + [_F] * 3 + [_I] * 2
                          + [_F] * 2 + [_I] + [_F] * 3 + [_P, _P, _L, _L]
                          + [_P] * 4 + [_I, _I, _P],
    # fb, mask_uw, mask_ue, mask_us, mask_un, mask_ut, mask_ub, uw, ue, us,
    # un, ut, ub, Z, Y, X, gy, gx, storage, stream
    "luw_vk_sites": [_P] * 13 + [_I] * 6 + [_P],
    # fi, flags, dyn, inv_n, mean_u, m2_u, mean_rho, Z, Y, X, storage, wall,
    # wall_cd, wall_cd_sides, stream
    "luw_avg_update": [_P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                       _F, _P],
    # x (f32), out (storage), n, storage, stream
    "luw_codec_encode": [_P, _P, _L, _I, _P],
    # bits (storage), out (f32), n, storage, stream
    "luw_codec_decode": [_P, _P, _L, _I, _P],
}


def sources() -> list[Path]:
    """The translation units passed to nvcc."""
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def extra_flags() -> list[str]:
    """The compile flags of $LUW_NVCC_FLAGS, split on whitespace."""
    return os.environ.get("LUW_NVCC_FLAGS", "").split()


def source_digest() -> str:
    h = hashlib.sha256()
    for p in sources() + headers():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for flag in extra_flags():
        h.update(flag.encode())
        if Path(flag).is_file():
            h.update(Path(flag).read_bytes())
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


def _run(cmd: list[str], label: str) -> str:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")
    return f"{out}# nvcc {label}: {time.perf_counter() - t0:.1f} s\n"


def build() -> tuple[Path, str]:
    """(library path, nvcc's output) — builds only when the library for the
    current sources does not exist yet; the output is then the build log."""
    digest = source_digest()
    lib = BUILD_DIR / f"libluwtorch_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    nvcc = find_nvcc()
    obj_dir = BUILD_DIR / f"{digest}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    objs = [obj_dir / f"{p.stem}.o" for p in srcs]
    cmds = [[nvcc, *COMPILE_FLAGS, *extra_flags(), "-I", str(CSRC_DIR), "-c",
             "-o", str(o), str(p)] for p, o in zip(srcs, objs)]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        with ThreadPoolExecutor(max_workers=max(1, len(cmds))) as pool:
            logs = list(pool.map(_run, cmds, [p.name for p in srcs]))
        logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)], "link"))
        out = "".join(logs)
        log.write_text(out)
        os.replace(tmp, lib)      # atomic: a reader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(obj_dir, ignore_errors=True)
    return lib, out


_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with every entry
    point's argument types declared.  Threads that first use it together
    (a case-parallel batch, one thread per card) build it once: the build
    directory's object and temporary names are per process."""
    with _BUILD_LOCK:
        path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
