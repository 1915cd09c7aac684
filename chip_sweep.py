"""Sweep the tiled body's compile-time shapes on one NVIDIA card.

    python3 chip_sweep.py [--parent OTHER_CHECKOUT]

The tiled body of the step kernel (`csrc/stream_collide_tiled.cuh`: the
thermal, wall-model and TRT instances) takes one shape per family at compile
time, `tile_shape`: threads along x and y, planes per block, the minimum
resident blocks per SM (which caps the registers) and how many planes ahead
the sources are prefetched into L2.  Each entry of VARIANTS sets the shapes
of the 2-byte thermal family and of the wall-model/TRT one (the f32 thermal
family keeps its own: the cases are bf16) in a small header that the port's
own build pre-includes (`LUW_NVCC_FLAGS="-include <header>"`,
utils/cuda_build.py); "kept" is the committed source as it stands.  The variants are built two at a time; then
each runs in a process of its own, in turns (forward, then backward).  On its
first turn a variant prints its bf16 tiled instances' registers and spill
bytes and is held against the plain version at the ragged shape
(chip_smoke.compare_ragged: every storage, wall models, TRT and thermal; it
raises on any disagreement); on every turn it times K7 (the thermal step at
the NWP deck's grid, 1017x887x79) and K4 (`wall_sides` at the profile deck's
grid, 424x424x118), both bf16 with nudge + sponge and VK hook sites, by CUDA
events (chip_smoke.time_step_kernel).  With `--parent`, the other checkout
(the old body) times the same two cases first, in a process of its own.  The
last line is one JSON object.  It exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

# name: (thermal shape, other shape), each (threads x, threads y, planes per
# block, min blocks per SM, L2 prefetch planes); None: the committed shapes
VARIANTS = {
    "kept": None,
    "thermal 128x1x4, other 32x4x8": ((128, 1, 4, 4, 0), (32, 4, 8, 5, 1)),
    "thermal 64x2x8, other 128x1x8": ((64, 2, 8, 4, 0), (128, 1, 8, 5, 1)),
    "thermal 256x1x4, other 64x2x16": ((256, 1, 4, 2, 0), (64, 2, 16, 5, 1)),
    "thermal 128x2x8, other 64x4x8 3 blocks": ((128, 2, 8, 2, 0),
                                               (64, 4, 8, 3, 1)),
    "kept shapes, thermal prefetch 1, other 4 blocks no prefetch": (
        (256, 1, 8, 2, 1), (64, 2, 8, 4, 0)),
}

_TURN = r"""
import json, torch
import chip_smoke as c
out = {}
if CHECK:
    from latticeurbanwind_tpu_torch.utils import cuda_build
    _, log = cuda_build.build()
    regs, spills = c.kernel_registers(log)
    out["registers"] = {k: [v, list(spills.get(k, (0, 0)))]
                        for k, v in sorted(regs.items())
                        if k.startswith("stream_collide_tiled") and "BF16" in k}
    c.compare_ragged()
for key, shape, variant, thermal in (("K7", c.NWP_SHAPE, "", True),
                                     ("K4", c.MAIN_SHAPE, "wall+sides", False)):
    out[key] = c.time_step_kernel(shape, "bf16", True, vk=True, variant=variant,
                                  thermal=thermal, plain_reps=1)["ms"]
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def variant_env(work: Path, name: str, shapes) -> dict:
    """The environment of a variant's processes: its header pre-included."""
    env = dict(os.environ)
    env.pop("LUW_NVCC_FLAGS", None)
    if shapes is not None:
        header = work / f"variant_{list(VARIANTS).index(name)}.h"
        header.write_text(
            "".join(f"#define LUW_TILE_{fam} {', '.join(map(str, s))}\n"
                    for fam, s in zip(("THERMAL", "OTHER"), shapes)))
        env["LUW_NVCC_FLAGS"] = f"-include {header}"
    return env


def run(code: str, cwd: Path, env: dict, label: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=1500)
    for line in proc.stdout.splitlines():
        if not line.startswith("RESULT "):
            print(f"  [{label}] {line}", flush=True)
    if proc.returncode:
        raise RuntimeError(f"{label}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def build(env: dict, label: str) -> None:
    """The variant's library, built by the port's own build."""
    proc = subprocess.run(
        [sys.executable, "-c", "from latticeurbanwind_tpu_torch.utils import "
         "cuda_build; cuda_build.build()"], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=1200)
    if proc.returncode:
        raise RuntimeError(f"{label}: build failed\n{proc.stderr[-4000:]}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_sweep: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    parent = None
    if "--parent" in argv:
        other = Path(argv[argv.index("--parent") + 1]).resolve()
        env = dict(os.environ)
        env.pop("LUW_NVCC_FLAGS", None)
        parent = run("CHECK = False\n" + _TURN, other, env, "parent")
        print(f"parent ({other}): K7 {parent['K7']:.3f} ms, "
              f"K4 {parent['K4']:.3f} ms", flush=True)
    work = Path(tempfile.mkdtemp(prefix="chip_sweep_"))
    try:
        envs = {n: variant_env(work, n, s) for n, s in VARIANTS.items()}
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda n: build(envs[n], n), VARIANTS))
        got = {n: {"shapes": s, "K7": [], "K4": []} for n, s in VARIANTS.items()}
        names = list(VARIANTS)
        for first, order in ((True, names), (False, names[::-1])):
            for n in order:
                r = run(f"CHECK = {first}\n" + _TURN, HERE, envs[n], n)
                if first:
                    got[n]["registers"] = r["registers"]
                    print(f"{n}: bf16 tiled instances " + ", ".join(
                        f"{k.split('<')[1].rstrip('>')} {v[0]} registers"
                        + (f" spills {tuple(v[1])}" if any(v[1]) else "")
                        for k, v in r["registers"].items()), flush=True)
                for key in ("K7", "K4"):
                    got[n][key].append(r[key])
                print(f"{n}: K7 {r['K7']:.3f} ms, K4 {r['K4']:.3f} ms",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for n, g in got.items():
        g["K7_ms"], g["K4_ms"] = (sum(g[k]) / len(g[k]) for k in ("K7", "K4"))
        print(f"mean {n}: K7 {g['K7_ms']:.3f} ms, K4 {g['K4_ms']:.3f} ms")
    print(smi)
    print(json.dumps({"smi": smi, "parent_ms": parent, "variants": got}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
