"""Compare two checkouts of the PyTorch port on one NVIDIA card.

    python3 chip_compare.py OTHER_CHECKOUT [--turns 2]

Builds both checkouts' kernels (each in its own `_build/`), prints every
kernel instance's ptxas register count and SASS instruction count (by
`cuobjdump -sass`) side by side, with the instances named by their
template arguments so that checkouts whose templates took fewer arguments
line up (a missing wall, TRT, thermal or halo argument reads as 0), and
then times, in turns (other, this, this, other, ...), the configurations
both take: K-SC at 256^3 in bf16, f32 and fp16c (flagship) and bf16 with
nudge + sponge, and K-AVG at 256^3 in bf16 and fp16c, by CUDA events, each
turn in a fresh process of its checkout.  The last line is one JSON object with the
registers and the times.  It exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# run in each checkout: its own chip_smoke's cases and timers
_TURN = r"""
import json, torch
import chip_smoke as c
from latticeurbanwind_tpu_torch.utils import cuda_build
lib, log = cuda_build.build()
out = {"log": log, "lib": str(lib), "times": {}}
def ms(t):
    return t["ms"] if isinstance(t, dict) else t[0]
if TIMES:
    for name, storage, forcing in (("K-SC 256^3 bf16 flagship", "bf16", False),
                                   ("K-SC 256^3 bf16 nudge+sponge", "bf16", True),
                                   ("K-SC 256^3 f32 flagship", "f32", False),
                                   ("K-SC 256^3 fp16c flagship", "fp16c", False)):
        out["times"][name] = ms(c.time_step_kernel(c.CUBE, storage, forcing,
                                                    plain_reps=1))
        torch.cuda.empty_cache()
    for storage in ("bf16", "fp16c"):
        out["times"][f"K-AVG 256^3 {storage}"] = ms(c.time_avg_kernel(c.CUBE,
                                                                      storage))
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def turn(checkout: Path, times: bool) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", f"TIMES = {times}\n" + _TURN], cwd=checkout,
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def sass_sizes(lib: str) -> dict:
    """{kernel instance (as kernel_registers names it): SASS instructions}
    of a built library, by cuobjdump."""
    from chip_smoke import kernel_registers

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True, timeout=300).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"no SASS sizes: {tool}: {e}")
        return {}
    sizes, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            regs, _ = kernel_registers(
                f"Compiling entry function '{mangled}'\nUsed 0 registers")
            name = next(iter(regs), mangled)
            sizes[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            sizes[name] += 1
    return sizes


def padded(regs: dict) -> dict:
    """Instance names with the template arguments an older checkout lacks
    (stream_collide_kernel: wall, trt, thermal, halo; avg_update_kernel:
    wall) as 0."""
    out = {}
    for name, n in regs.items():
        base, args = name.rstrip(">").split("<")
        args = args.split(",")
        want = {"stream_collide_kernel": 8, "avg_update_kernel": 2}.get(base)
        if want:
            args += ["0"] * (want - len(args))
        out[f"{base}<{','.join(args)}>"] = n
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: torch.cuda.is_available() is false")
    other = Path(argv[1]).resolve()
    turns = int(argv[argv.index("--turns") + 1]) if "--turns" in argv else 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import kernel_registers

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    regs, sizes = {}, {}
    for tag, path in (("other", other), ("this", HERE)):
        built = turn(path, False)
        regs[tag] = padded(kernel_registers(built["log"])[0])
        sizes[tag] = padded(sass_sizes(built["lib"]))
    same = sorted(set(regs["other"]) & set(regs["this"]))
    for name in same:
        a, b = regs["other"][name], regs["this"][name]
        sa, sb = sizes["other"].get(name), sizes["this"].get(name)
        print(f"{name}: registers other {a}, this {b}; SASS instructions "
              f"other {sa}, this {sb}"
              f"{'' if (a, sa) == (b, sb) else '  DIFFERS'}")
    for name in sorted(set(regs["this"]) - set(regs["other"])):
        print(f"{name} (this checkout only): {regs['this'][name]} registers, "
              f"{sizes['this'].get(name)} SASS instructions")
    times = {"other": [], "this": []}
    order = ["other", "this", "this", "other"] * ((turns + 1) // 2)
    for tag in order[:2 * turns]:
        t = turn(other if tag == "other" else HERE, True)["times"]
        times[tag].append(t)
        print(f"{tag}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()),
              flush=True)
    means = {tag: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]}
             for tag, ts in times.items()}
    for k in means["this"]:
        a, b = means["other"][k], means["this"][k]
        print(f"{k}: other {a:.4f} ms, this {b:.4f} ms ({100 * (b / a - 1):+.2f}%)")
    print(smi)
    print(json.dumps({"smi": smi, "registers": regs, "sass_instructions": sizes,
                      "times": times, "means": means}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
