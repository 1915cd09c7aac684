"""Accelerator environment probing — the port's `luwenv`.

The reference probes/repairs CUDA wheel layouts for numba and checks OpenCL
ICDs; the JAX package probes its backend and the TPU.  Here the report
covers what the port's runs need: torch and its CUDA version, the visible
cards (name, memory, compute capability), the nvcc that builds the kernels,
the kernel build directory with the library for the current sources (built
or not: the probe builds nothing), and the native C++ helpers.  It prints
the same style of JSON environment report the pipeline logs.

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwenv
"""

from __future__ import annotations

import json
import shutil
import sys


def probe_cuda_environment() -> dict:
    import torch

    from . import cuda_build

    report = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [],
        "nvcc": None,
        "kernel_build_dir": str(cuda_build.BUILD_DIR),
        "kernel_library": None,
        "native_toolchain": {
            "g++": shutil.which("g++"),
            "cmake": shutil.which("cmake"),
            "ninja": shutil.which("ninja"),
        },
        "errors": [],
    }
    if report["cuda_available"]:
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            report["devices"].append({
                "index": i, "name": p.name,
                "memory_gib": round(p.total_memory / 2**30, 1),
                "capability": f"{p.major}.{p.minor}",
                "multiprocessors": p.multi_processor_count,
            })
    try:
        report["nvcc"] = cuda_build.find_nvcc()
    except RuntimeError as e:
        report["errors"].append(f"nvcc: {e}")
    lib = cuda_build.BUILD_DIR / f"libluwtorch_{cuda_build.source_digest()}.so"
    report["kernel_library"] = {"path": str(lib), "built": lib.exists()}
    try:
        from .native import load

        report["native_library"] = "loaded" if load() is not None else "unavailable"
    except Exception as e:
        report["errors"].append(f"native: {type(e).__name__}: {e}")
    return report


def main(argv=None) -> int:
    print(json.dumps(probe_cuda_environment(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
