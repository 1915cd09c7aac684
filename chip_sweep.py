"""Sweep the tiled body's compile-time shapes on one NVIDIA card.

    python3 chip_sweep.py [--parent OTHER_CHECKOUT]
                          [--family plain|pair|plain32|other|avg]
                          [--only NAME[;NAME...]]

The tiled body of the step kernel (`csrc/stream_collide_tiled.cuh`) takes one
shape per family at compile time, `tile_shape`: threads along x and y,
planes per block, the minimum resident blocks per SM (which caps the
registers) and how many planes ahead the sources are prefetched into L2;
the averaging pass (K-AVG, `csrc/avg_update.cu`) marches the same way with
its own shape, LUW_TILE_AVG.
Each entry of a family's variants sets some families' shapes in a small
header that the port's own build pre-includes
(`LUW_NVCC_FLAGS="-include <header>"`, utils/cuda_build.py); "kept" is the
committed source as it stands.  The variants are built two at a time; then
each runs in a process of its own, in turns (forward, then backward).  On
its first turn a variant prints its tiled instances' registers and spill
bytes in the family's storages and is held against the plain version
(chip_smoke.compare_ragged: every storage and family at the ragged shape;
for the plain family also chip_smoke.compare_halo's slabs; for avg
chip_smoke.compare_avg_ragged; it raises on any disagreement); on every
turn it times its family's cases by CUDA events (chip_smoke.time_step_kernel,
time_halo_kernel, time_avg_kernel), with nudge + sponge and VK hook sites
unless said:

  plain (default; LUW_TILE_PLAIN: no wall model, SRT, not thermal, bf16 and
      f16 where X is odd or in halo mode): K1-K3 in bf16 at the NWP deck's
      grid without T (1017x887x79), and K8 at the split deck's shard
      (59x214x424);
  pair (LUW_TILE_PLAIN_PAIR: the plain family's paired instance, bf16 and
      f16 with X even, two cells per thread along x; checked by
      chip_smoke.compare_pair at the ragged shapes): K1-K3 in bf16 at the
      profile deck's grid (its VK hook's sites) and at the `.luwdg` deck's
      grid (270x270x68, no sites);
  plain32 (LUW_TILE_PLAIN_F32_FP16C: the same family in f32 and fp16c):
      K1-K3 at the profile deck's grid in fp16c (as `vk-fp16c-200` runs it)
      and f32, and the 256^3 flagship (no forcing, no sites) in both;
  other: K7 (thermal, NWP grid) and K4 (`wall_sides`, profile grid), bf16;
  avg (LUW_TILE_AVG without a wall model, LUW_TILE_AVG_WALL with one; each
      variant sets both): K-AVG in bf16 without a wall model and with
      `wall_sides` at the profile deck's grid and at the NWP deck's grid.

With `--parent`, the other checkout takes part in the turns as one more
variant (first and last); `--only` keeps the named variants alone.  The last
line is one JSON object.  It exits non-zero without a card.
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

# name: {family: (threads x, threads y, planes per block, min blocks per SM,
# L2 prefetch planes)}; None: the committed shapes.  PLAIN_PAIR's threads
# along x own two cells each.
VARIANTS = {
    "plain": {
        "kept": None,
        "plain 64x2x8, 5 blocks": {"PLAIN": (64, 2, 8, 5, 0)},
        "plain 128x1x8, 6 blocks, prefetch 1": {"PLAIN": (128, 1, 8, 6, 1)},
    },
    "pair": {
        "kept": None,
        "pair 32x4x8, 4 blocks": {"PLAIN_PAIR": (32, 4, 8, 4, 0)},
        "pair 32x4x8, 5 blocks": {"PLAIN_PAIR": (32, 4, 8, 5, 0)},
        "pair 64x2x8, 4 blocks": {"PLAIN_PAIR": (64, 2, 8, 4, 0)},
        "pair 32x2x8, 8 blocks": {"PLAIN_PAIR": (32, 2, 8, 8, 0)},
    },
    "plain32": {
        "kept": None,
        "plain32 64x2x8, 6 blocks": {"PLAIN_F32_FP16C": (64, 2, 8, 6, 0)},
        "plain32 64x2x16, 5 blocks": {"PLAIN_F32_FP16C": (64, 2, 16, 5, 0)},
        "plain32 128x1x8, 6 blocks": {"PLAIN_F32_FP16C": (128, 1, 8, 6, 0)},
    },
    "other": {
        "kept": None,
        "thermal 128x1x4, other 32x4x8": {"THERMAL": (128, 1, 4, 4, 0),
                                          "OTHER": (32, 4, 8, 5, 1)},
        "thermal 64x2x8, other 128x1x8": {"THERMAL": (64, 2, 8, 4, 0),
                                          "OTHER": (128, 1, 8, 5, 1)},
    },
    "avg": {
        "kept": None,
        "avg 128x1x8, 7 blocks": {"AVG": (128, 1, 8, 7, 0),
                                  "AVG_WALL": (128, 1, 8, 7, 0)},
        "avg 128x1x8, 8 blocks": {"AVG": (128, 1, 8, 8, 0),
                                  "AVG_WALL": (128, 1, 8, 8, 0)},
        "avg 128x1x8, 5 blocks": {"AVG": (128, 1, 8, 5, 0),
                                  "AVG_WALL": (128, 1, 8, 5, 0)},
        "avg 64x2x8, 7 blocks": {"AVG": (64, 2, 8, 7, 0),
                                 "AVG_WALL": (64, 2, 8, 7, 0)},
        "avg 256x1x8, 3 blocks": {"AVG": (256, 1, 8, 3, 0),
                                  "AVG_WALL": (256, 1, 8, 3, 0)},
        "avg 128x1x16, 7 blocks": {"AVG": (128, 1, 16, 7, 0),
                                   "AVG_WALL": (128, 1, 16, 7, 0)},
        "avg 128x1x8, 6 blocks, prefetch 1": {"AVG": (128, 1, 8, 6, 1),
                                              "AVG_WALL": (128, 1, 8, 6, 1)},
    },
}
# the storages whose instances a variant's first turn lists
CODECS = {"plain": ("BF16",), "pair": ("BF16",), "plain32": ("F32", "FP16C"),
          "other": ("BF16",),
          "avg": ("F32", "BF16", "F16", "FP16C")}

_TURN = r"""
import json, torch
import chip_smoke as c
from latticeurbanwind_tpu_torch.parallel import domain_mesh
out = {}
if CHECK:
    from latticeurbanwind_tpu_torch.utils import cuda_build
    _, log = cuda_build.build()
    regs, spills = c.kernel_registers(log)
    kernel = "avg_update" if FAMILY == "avg" else "stream_collide_tiled"
    out["registers"] = {k: [v, list(spills.get(k, (0, 0)))]
                        for k, v in sorted(regs.items())
                        if k.startswith(kernel)
                        and k.split("<")[1].split(",")[0] in CODECS}
    if FAMILY == "avg":
        c.compare_avg_ragged()
    elif FAMILY == "pair":
        c.compare_pair(big=False)
    else:
        c.compare_ragged()
    if FAMILY == "plain":
        c.compare_halo((24, 72, 136))
if FAMILY == "plain":
    out["K1-K3 NWP"] = c.time_step_kernel(c.NWP_SHAPE, "bf16", True, vk=True,
                                          plain_reps=1)["ms"]
    torch.cuda.empty_cache()
    local = domain_mesh(c.SHARD_SPLIT, c.MAIN_SHAPE, "cpu").local_shape(0)
    out["K8 shard"] = c.time_halo_kernel(local)["ms"]
elif FAMILY == "pair":
    for key, shape, vk in (("K1-K3 main", c.MAIN_SHAPE, True),
                           ("K1-K3 .luwdg", (68, 270, 270), False)):
        out[key] = c.time_step_kernel(shape, "bf16", True, vk=vk,
                                      plain_reps=1)["ms"]
        torch.cuda.empty_cache()
elif FAMILY == "plain32":
    for storage in ("fp16c", "f32"):
        out[f"K1-K3 main {storage}"] = c.time_step_kernel(
            c.MAIN_SHAPE, storage, True, vk=True, plain_reps=1)["ms"]
        torch.cuda.empty_cache()
        out[f"256^3 {storage} flagship"] = c.time_step_kernel(
            c.CUBE, storage, False, plain_reps=1)["ms"]
        torch.cuda.empty_cache()
elif FAMILY == "avg":
    for key, shape, variant in (("main", c.MAIN_SHAPE, ""),
                                ("main wall_sides", c.MAIN_SHAPE, "wall+sides"),
                                ("NWP", c.NWP_SHAPE, ""),
                                ("NWP wall_sides", c.NWP_SHAPE, "wall+sides")):
        out[f"K-AVG {key}"] = c.time_avg_kernel(shape, "bf16", variant)["ms"]
        torch.cuda.empty_cache()
else:
    for key, shape, variant, thermal in (("K7", c.NWP_SHAPE, "", True),
                                         ("K4", c.MAIN_SHAPE, "wall+sides", False)):
        out[key] = c.time_step_kernel(shape, "bf16", True, vk=True,
                                      variant=variant, thermal=thermal,
                                      plain_reps=1)["ms"]
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def variant_env(work: Path, index: int, spec) -> dict:
    """The environment of a variant's processes: its header pre-included."""
    env = dict(os.environ)
    env.pop("LUW_NVCC_FLAGS", None)
    if spec is not None:
        header = work / f"variant_{index}.h"
        header.write_text("".join(
            f"#define LUW_TILE_{fam} {', '.join(map(str, shape))}\n"
            for fam, shape in spec.items()))
        env["LUW_NVCC_FLAGS"] = f"-include {header}"
    return env


def run(code: str, cwd: Path, env: dict, label: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=1500)
    if proc.returncode:
        raise RuntimeError(f"{label}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
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
    family = argv[argv.index("--family") + 1] if "--family" in argv else "plain"
    variants = VARIANTS[family]
    if "--only" in argv:
        keep = argv[argv.index("--only") + 1].split(";")
        variants = {n: s for n, s in variants.items() if n in keep}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    head = f"FAMILY = {family!r}\nCODECS = {CODECS[family]!r}\n"
    other = (Path(argv[argv.index("--parent") + 1]).resolve()
             if "--parent" in argv else None)
    work = Path(tempfile.mkdtemp(prefix="chip_sweep_"))
    try:
        envs = {n: variant_env(work, i, s)
                for i, (n, s) in enumerate(variants.items())}
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda n: build(envs[n], n), variants))
        got = {n: {"spec": s, "ms": {}} for n, s in variants.items()}
        names = list(variants)
        if other is not None:
            # the parent's own build, in turns with the variants
            envs["parent"] = variant_env(work, len(names), None)
            got["parent"] = {"spec": str(other), "ms": {}}
            names = ["parent"] + names
        for first, order in ((True, names), (False, names[::-1])):
            for n in order:
                check = first and n != "parent"
                r = run(head + f"CHECK = {check}\n" + _TURN,
                        other if n == "parent" else HERE, envs[n], n)
                if check:
                    got[n]["registers"] = r.pop("registers")
                    print(f"{n}: tiled instances " + ", ".join(
                        f"{k.split('<')[1].rstrip('>')} {v[0]} registers"
                        + (f" spills {tuple(v[1])}" if any(v[1]) else "")
                        for k, v in got[n]["registers"].items()), flush=True)
                for k, v in r.items():
                    got[n]["ms"].setdefault(k, []).append(v)
                print(f"{n}: " + ", ".join(f"{k} {v:.4f} ms"
                                           for k, v in r.items()), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for n, g in got.items():
        g["mean_ms"] = {k: sum(v) / len(v) for k, v in g["ms"].items()}
        print(f"mean {n}: " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in g["mean_ms"].items()))
    print(smi)
    print(json.dumps({"smi": smi, "family": family, "variants": got}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
