"""Compare two checkouts of the PyTorch port on one NVIDIA card.

    python3 chip_compare.py OTHER_CHECKOUT [--turns 2]

Builds both checkouts' kernels (each in its own `_build/`), prints every
kernel instance's ptxas register count and SASS instruction count (by
`cuobjdump -sass`) side by side, with the instances named by their
template arguments so that checkouts whose templates took fewer arguments
line up (a missing wall, TRT, thermal or halo argument reads as 0), and an
instance of the old step body (`stream_collide_kernel<...>`) lines up with
the tiled body's instance that runs its configuration (the same arguments,
nudging and the sponge as run-time switches where those are); then steps the same cases
in each checkout -- bf16, nudge + sponge, VK hook sites, 5 steps at
CODES_SHAPE: `wall_sides`, thermal, and the plain configuration (no wall
model, SRT: K1-K3) in every storage; and the split runner with every shard
on card 0 (K8, SPLIT of SPLIT_SHAPE, bf16, 6 steps) -- and counts the stored
codes of the final f (and g) that differ between the two; and then times,
in turns (other, this, this, other, ...), the configurations both take:
K-SC at 256^3 in bf16, f32 and fp16c (flagship), bf16 with nudge + sponge,
bf16 thermal and bf16 `wall_sides` (both with nudge + sponge), K-SC thermal
at the NWP deck's grid with VK sites, K-SC (K1-K3) with VK sites at the
profile deck's grid in bf16 and fp16c (as `vk-bf16-400` and `vk-fp16c-200`
run it) and at the NWP deck's grid, K8 at the split deck's shard, and
K-AVG at 256^3 in bf16 and fp16c, by CUDA events, each turn in a fresh process of its checkout.  The last line
is one JSON object with the registers, the code comparison and the times.
It exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
CODES_SHAPE = (40, 120, 200)      # the code comparison's grid
SPLIT_SHAPE = (24, 72, 136)       # the split runner's grid and its
SPLIT = (1, 2, 5)                 # [Dx, Dy, Dz]: uneven slabs of 4-5 planes

# run in each checkout: its own chip_smoke's cases and timers
_TURN = r"""
import json, torch
import chip_smoke as c
from latticeurbanwind_tpu_torch.parallel import domain_mesh
from latticeurbanwind_tpu_torch.utils import cuda_build
lib, log = cuda_build.build()
out = {"log": log, "lib": str(lib), "times": {}}
def ms(t):
    return t["ms"] if isinstance(t, dict) else t[0]
if CODES:
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide,
    )
    cases = [("wall_sides", "bf16", "wall+sides", False),
             ("thermal", "bf16", "", True)]
    cases += [(f"plain {s}", s, "", False) for s in c.STORAGES]
    for tag, storage, variant, thermal in cases:
        cfg, st, frc, row = c.make_case(SHAPE, storage, inflow=0.05,
                                        variant=variant, thermal=thermal)
        pre, _ = c.vk_hook(st)
        spec = pre.ddf.kernel_spec
        fbc, aux = build_face_bc(st.u, st.T), pre.ddf.init_aux(0)
        f, g = st.fi, ([st.gi, torch.empty_like(st.gi)] if thermal
                       else [None, None])
        for t in range(5):
            fbc, aux = pre.ddf(fbc, t, aux)
            f = stream_collide(f, st.flags, row, cfg, frc, fbc, vk=spec,
                               gi=g[0], gi_out=g[1])
            g.reverse()
        torch.save({"f": f.cpu(), "g": None if g[0] is None else g[0].cpu()},
                   f"{CODES}/{tag}.pt")
        torch.cuda.empty_cache()
    # K8: the split runner, every shard on card 0
    from latticeurbanwind_tpu_torch.lbm.state import DynParams
    from latticeurbanwind_tpu_torch.parallel import (
        domain_mesh, gather_state, shard_state,
    )
    from latticeurbanwind_tpu_torch.parallel.halo import make_sharded_runner
    cfg, st, frc, row = c.make_case(SPLIT_SHAPE, "bf16", inflow=0.05)
    dyn = DynParams(force=row[:3].cpu(), omega_coriolis=row[3:6].cpu())
    pre, _ = c.vk_hook(st)
    mesh = domain_mesh(SPLIT, SPLIT_SHAPE, "cuda:0")
    srun, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre)
    got = gather_state(srun(shard_state(st, mesh), dyn, 0, 6), "cuda")
    torch.save({"f": got.fi.cpu(), "g": None}, f"{CODES}/split.pt")
if TIMES:
    for name, storage, forcing in (("K-SC 256^3 bf16 flagship", "bf16", False),
                                   ("K-SC 256^3 bf16 nudge+sponge", "bf16", True),
                                   ("K-SC 256^3 f32 flagship", "f32", False),
                                   ("K-SC 256^3 fp16c flagship", "fp16c", False)):
        out["times"][name] = ms(c.time_step_kernel(c.CUBE, storage, forcing,
                                                    plain_reps=1))
        torch.cuda.empty_cache()
    for name, kw in (("K-SC 256^3 bf16 thermal nudge+sponge",
                      dict(thermal=True)),
                     ("K-SC 256^3 bf16 wall_sides nudge+sponge",
                      dict(variant="wall+sides"))):
        out["times"][name] = ms(c.time_step_kernel(c.CUBE, "bf16", True,
                                                    plain_reps=1, **kw))
        torch.cuda.empty_cache()
    out["times"]["K-SC NWP grid bf16 thermal nudge+sponge VK sites"] = ms(
        c.time_step_kernel(c.NWP_SHAPE, "bf16", True, vk=True, thermal=True,
                           plain_reps=1))
    torch.cuda.empty_cache()
    for name, shape, storage in (
            ("K-SC main grid bf16 nudge+sponge VK sites", c.MAIN_SHAPE, "bf16"),
            ("K-SC main grid fp16c nudge+sponge VK sites", c.MAIN_SHAPE, "fp16c"),
            ("K-SC NWP grid bf16 nudge+sponge VK sites", c.NWP_SHAPE, "bf16")):
        out["times"][name] = ms(c.time_step_kernel(shape, storage, True,
                                                   vk=True, plain_reps=1))
        torch.cuda.empty_cache()
    local = domain_mesh(c.SHARD_SPLIT, c.MAIN_SHAPE, "cpu").local_shape(0)
    out["times"]["K8 shard bf16 nudge+sponge VK sites"] = c.time_halo_kernel(
        local)["ms"]
    torch.cuda.empty_cache()
    for storage in ("bf16", "fp16c"):
        out["times"][f"K-AVG 256^3 {storage}"] = ms(c.time_avg_kernel(c.CUBE,
                                                                      storage))
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def turn(checkout: Path, times: bool, codes: str = "") -> dict:
    """One fresh process in `checkout`: its build log and library, with
    `times` its timed configurations, with `codes` (a directory) the code
    comparison's final DDFs saved there."""
    head = (f"TIMES = {times}\nCODES = {codes!r}\n"
            f"SHAPE = {CODES_SHAPE!r}\nSPLIT_SHAPE = {SPLIT_SHAPE!r}\n"
            f"SPLIT = {SPLIT!r}\n")
    proc = subprocess.run(
        [sys.executable, "-c", head + _TURN], cwd=checkout,
        capture_output=True, text=True, timeout=1200)
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
    (stream_collide_kernel: wall, trt, thermal, halo;
    stream_collide_tiled_kernel: halo; avg_update_kernel: wall) as 0."""
    out = {}
    for name, n in regs.items():
        base, args = name.rstrip(">").split("<")
        args = args.split(",")
        want = {"stream_collide_kernel": 8, "stream_collide_tiled_kernel": 8,
                "avg_update_kernel": 2}.get(base)
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
    tmp = Path(tempfile.mkdtemp(prefix="chip_compare_"))
    for tag, path in (("other", other), ("this", HERE)):
        (tmp / tag).mkdir()
        built = turn(path, False, str(tmp / tag))
        regs[tag] = padded(kernel_registers(built["log"])[0])
        sizes[tag] = padded(sass_sizes(built["lib"]))
    codes = {}
    cases = ["wall_sides", "thermal"] + [f"plain {s}" for s in
                                         ("f32", "bf16", "f16", "fp16c")]
    for case in cases + ["split"]:
        a, b = (torch.load(tmp / tag / f"{case}.pt") for tag in ("other", "this"))
        for k in ("f", "g"):
            if a[k] is None:
                continue
            bits = torch.int32 if a[k].element_size() == 4 else torch.int16
            x, y = a[k].view(bits), b[k].view(bits)
            diff = x != y
            err = float((a[k].float() - b[k].float()).abs().max())
            codes[f"{case} {k}"] = {"differing": int(diff.sum()),
                                    "share": float(diff.float().mean()),
                                    "max_abs": err}
            where = (f"K8 bf16 split {list(SPLIT)} of {SPLIT_SHAPE} 6 steps"
                     if case == "split" else
                     f"{case if case.startswith('plain') else 'bf16 ' + case} "
                     f"{CODES_SHAPE} 5 steps")
            print(f"{where}, final {k}: "
                  f"{int(diff.sum())} of {x.numel()} stored codes differ "
                  f"between the checkouts (share {float(diff.float().mean()):.2e}"
                  f", max decoded difference {err:.3e})", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    # the other checkout's old-body instances against this one's tiled ones
    for tag in ("other", "this"):
        for d in (regs, sizes):
            for name in list(d[tag]):
                if name.startswith("stream_collide_kernel<"):
                    d[tag]["stream_collide_tiled_kernel<" + name.split("<")[1]
                           + " (old body)"] = d[tag].pop(name)
    for name in sorted(regs["other"]):
        if name.endswith(" (old body)"):
            args = name[:-len(" (old body)")].rstrip(">").split("<")[1].split(",")
            tiled = f"stream_collide_tiled_kernel<{','.join(args)}>"
            if tiled not in regs["this"] and args[1] == "1":
                # with the volume force, nudging and the sponge are run-time
                # switches (2)
                args[2:4] = ["2", "2"]
                tiled = f"stream_collide_tiled_kernel<{','.join(args)}>"
            print(f"{name}: registers {regs['other'][name]}, SASS instructions "
                  f"{sizes['other'].get(name)}; runs as {tiled}: registers "
                  f"{regs['this'].get(tiled)}, SASS instructions "
                  f"{sizes['this'].get(tiled)}")
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
                      "codes": codes, "times": times, "means": means}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
