"""Compare two checkouts of the PyTorch port on one NVIDIA card.

    python3 chip_compare.py OTHER_CHECKOUT [--turns 2]

Builds both checkouts' kernels (each in its own `_build/`), prints every
kernel instance's ptxas register count and SASS instruction count (by
`cuobjdump -sass`) side by side, with the instances named by their
template arguments so that checkouts whose templates took fewer arguments
line up (a missing halo or wall argument reads as 0), and a summary of
the step's (K-SC's) instances; then runs the same cases in each checkout
and counts the stored codes that differ between the two: at CODES_SHAPE
with the VK hook's sites -- bf16 `wall_sides`, bf16 thermal (f and g),
the plain configuration (no wall model, SRT: K1-K3) in every storage, and
bf16 with random sites on all six faces (this checkout's
`chip_smoke.all_face_sites`, in both) -- the first step without sites,
the first step with them (the codes that differ must lie on cells whose
site mask is set: a checkout whose step matches but whose site pass
rounds otherwise moves those alone) and 5 steps with them; at the
benchmark cells' grids (BENCH_SHAPES, bf16 nudge + sponge) the first step
and 5 steps, with the VK hook's sites at the profile deck's grid; and the split
runner with every shard on card 0 (K8, SPLIT of SPLIT_SHAPE, bf16, its
slabs' sites inside their ghost rows) after 1 and 6 steps; and K-AVG's three
accumulators after 3 samples, bit for bit, without a wall model and with
`wall_sides`, in every storage, on the LUW-shell case and on one with
solid cells on all six boundary planes; and then times, in turns (other,
this, this, other, ...), the configurations both take: K-SC at 256^3 in
bf16, f32 and fp16c (flagship), bf16 with nudge + sponge, bf16 thermal and
bf16 `wall_sides` (both with nudge + sponge), K-SC thermal at the NWP
deck's grid with VK sites, K-SC (K1-K3) without and with VK sites at the
profile deck's grid in bf16 and fp16c (as `vk-bf16-400` and `vk-fp16c-200`
run it) and at the NWP deck's grid (with less without is the site pass),
K-SC bf16 with nudge + sponge at the `.luwdg` deck's grid, K8
at the split deck's shard, and K-AVG at 256^3 in bf16 and fp16c, at the
profile deck's grid without a wall model and with `wall_sides` and at the
NWP deck's grid, by CUDA events, each turn in a fresh process of its
checkout.  The last line is one JSON object with the registers, the code
comparison and the times.  It exits non-zero without a card.
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
BENCH_SHAPES = ((118, 424, 424),  # and the benchmark cells' grids: the
                (68, 270, 270))   # profile deck at 1.5 m, the .luwdg at 2 m
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
    import importlib.util
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import (
        build_face_bc, stream_collide,
    )
    from latticeurbanwind_tpu_torch.run.welford import init_avg

    # the site masks and their cells from the comparing checkout's helpers,
    # so that both checkouts step the same sites
    spec_ = importlib.util.spec_from_file_location("here_smoke", HERE_SMOKE)
    here = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(here)

    cases = [("wall_sides", "bf16", "wall+sides", False, False),
             ("thermal", "bf16", "", True, False),
             ("six faces bf16", "bf16", "", False, True)]
    cases += [(f"plain {s}", s, "", False, False) for s in c.STORAGES]
    for tag, storage, variant, thermal, six in cases:
        cfg, st, frc, row = c.make_case(SHAPE, storage, inflow=0.05,
                                        variant=variant, thermal=thermal)
        pre, _ = c.vk_hook(st)
        spec = here.all_face_sites(SHAPE) if six else pre.ddf.kernel_spec
        fbc, aux = build_face_bc(st.u, st.T), pre.ddf.init_aux(0)
        f, g = st.fi, ([st.gi, torch.empty_like(st.gi)] if thermal
                       else [None, None])
        saved = {"set": here.site_faces(spec, SHAPE, only_set=True)}
        for t in range(5):
            fbc, aux = pre.ddf(fbc, t, aux)
            if t == 0:
                # the first step without sites and with them, same inputs
                saved["f0"] = stream_collide(f, st.flags, row, cfg, frc, fbc,
                                             gi=g[0], gi_out=torch.empty_like(
                                                 g[0]) if thermal else None
                                             ).cpu()
            f = stream_collide(f, st.flags, row, cfg, frc, fbc, vk=spec,
                               gi=g[0], gi_out=g[1])
            g.reverse()
            if t == 0:
                saved["f1"] = f.cpu()
        saved.update(f=f.cpu(), g=None if g[0] is None else g[0].cpu())
        torch.save(saved, f"{CODES}/{tag}.pt")
        torch.cuda.empty_cache()
    # the benchmark cells' grids, bf16 nudge + sponge: the first step, then
    # 5 steps with the VK hook's sites (the profile deck) or without (.luwdg)
    for shape, hook in zip(BENCH_SHAPES, (True, False)):
        cfg, st, frc, row = c.make_case(shape, "bf16", inflow=0.05)
        pre, _ = c.vk_hook(st) if hook else (None, None)
        fbc = build_face_bc(st.u)
        aux = pre.ddf.init_aux(0) if hook else None
        f = st.fi
        for t in range(5):
            if hook:
                fbc, aux = pre.ddf(fbc, t, aux)
            if t == 0:
                f0 = stream_collide(f, st.flags, row, cfg, frc, fbc).cpu()
            f = stream_collide(f, st.flags, row, cfg, frc, fbc,
                               vk=pre.ddf.kernel_spec if hook else None)
        torch.save({"f0": f0, "f": f.cpu(), "g": None},
                   f"{CODES}/bench {'x'.join(map(str, shape))}.pt")
        del st, f, f0, fbc, pre
        torch.cuda.empty_cache()
    # K-AVG: 3 samples from successive steps' DDFs
    for storage in c.STORAGES:
        for variant in ("", "wall+sides"):
            for wrap in (False, True):
                cfg, st, frc, row = c.make_case(SHAPE, storage, inflow=0.05,
                                                variant=variant, wrap=wrap)
                avg, f = init_avg(SHAPE, False, "cuda"), st.fi
                fbc = build_face_bc(st.u)
                for k in range(3):
                    avg = avg_update(f, st.flags, row, 1.0 / (k + 1), avg, cfg)
                    f = stream_collide(f, st.flags, row, cfg, frc, fbc)
                tag = (f"K-AVG {storage} {variant or 'no wall'}"
                       f"{' solids on the boundary planes' if wrap else ''}")
                torch.save({k: getattr(avg, k).cpu()
                            for k in ("mean_u", "m2_u", "mean_rho")},
                           f"{CODES}/{tag}.pt")
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
    srun, _ = make_sharded_runner(cfg, frc, mesh, pre_step=pre, init_u=st.u)
    one = gather_state(srun(shard_state(st, mesh), dyn, 0, 1), "cuda")
    got = gather_state(srun(shard_state(st, mesh), dyn, 0, 6), "cuda")
    torch.save({"f1": one.fi.cpu(), "f": got.fi.cpu(), "g": None,
                "set": here.site_faces(pre.ddf.kernel_spec, SPLIT_SHAPE,
                                       only_set=True)},
               f"{CODES}/split.pt")
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
    out["times"]["K-SC sweep grid bf16 nudge+sponge"] = ms(
        c.time_step_kernel(BENCH_SHAPES[1], "bf16", True, plain_reps=1))
    torch.cuda.empty_cache()
    for name, shape, storage in (
            ("K-SC main grid bf16 nudge+sponge", c.MAIN_SHAPE, "bf16"),
            ("K-SC main grid fp16c nudge+sponge", c.MAIN_SHAPE, "fp16c"),
            ("K-SC NWP grid bf16 nudge+sponge", c.NWP_SHAPE, "bf16")):
        for vk in (False, True):
            out["times"][name + (" VK sites" if vk else "")] = ms(
                c.time_step_kernel(shape, storage, True, vk=vk, plain_reps=1))
            torch.cuda.empty_cache()
    local = domain_mesh(c.SHARD_SPLIT, c.MAIN_SHAPE, "cpu").local_shape(0)
    out["times"]["K8 shard bf16 nudge+sponge VK sites"] = c.time_halo_kernel(
        local)["ms"]
    torch.cuda.empty_cache()
    for name, shape, storage, variant in (
            ("K-AVG 256^3 bf16", c.CUBE, "bf16", ""),
            ("K-AVG 256^3 fp16c", c.CUBE, "fp16c", ""),
            ("K-AVG main grid bf16", c.MAIN_SHAPE, "bf16", ""),
            ("K-AVG main grid bf16 wall_sides", c.MAIN_SHAPE, "bf16",
             "wall+sides"),
            ("K-AVG NWP grid bf16", c.NWP_SHAPE, "bf16", "")):
        out["times"][name] = ms(c.time_avg_kernel(shape, storage, variant))
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""


def turn(checkout: Path, times: bool, codes: str = "") -> dict:
    """One fresh process in `checkout`: its build log and library, with
    `times` its timed configurations, with `codes` (a directory) the code
    comparison's final DDFs saved there."""
    head = (f"TIMES = {times}\nCODES = {codes!r}\n"
            f"HERE_SMOKE = {str(HERE / 'chip_smoke.py')!r}\n"
            f"SHAPE = {CODES_SHAPE!r}\nSPLIT_SHAPE = {SPLIT_SHAPE!r}\n"
            f"SPLIT = {SPLIT!r}\nBENCH_SHAPES = {BENCH_SHAPES!r}\n")
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
    (stream_collide_tiled_kernel: halo; avg_update_kernel: wall) as 0."""
    out = {}
    for name, n in regs.items():
        base, args = name.rstrip(">").split("<")
        args = args.split(",")
        want = {"stream_collide_tiled_kernel": 8, "avg_update_kernel": 2}.get(base)
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
    from latticeurbanwind_tpu_torch.lbm.state import decode_ddf

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
    cases = ["wall_sides", "thermal", "six faces bf16"] + [
        f"plain {s}" for s in ("f32", "bf16", "f16", "fp16c")]
    bench = [f"bench {'x'.join(map(str, s))}" for s in BENCH_SHAPES]
    for case in cases + ["split"] + bench:
        a, b = (torch.load(tmp / tag / f"{case}.pt") for tag in ("other", "this"))
        where = (f"K8 bf16 split {list(SPLIT)} of {SPLIT_SHAPE}"
                 if case == "split" else
                 f"bf16 nudge+sponge at the benchmark grid {case.split()[1]}"
                 if case in bench else
                 f"{case if case.startswith(('plain', 'six')) else 'bf16 ' + case} "
                 f"{CODES_SHAPE}")
        for k, what in (("f0", "1 step without sites"),
                        ("f1", "1 step with sites"),
                        ("f", f"{6 if case == 'split' else 5} steps with sites"
                              f"{' where the deck has them' if case in bench else ''}"),
                        ("g", "5 steps with sites")):
            if a.get(k) is None:
                continue
            bits = torch.int32 if a[k].element_size() == 4 else torch.int16
            diff = a[k].view(bits) != b[k].view(bits)
            storage = case.split()[-1] if case.startswith("plain") else "bf16"
            err = float((decode_ddf(a[k], storage)
                         - decode_ddf(b[k], storage)).abs().max())
            rec = {"differing": int(diff.sum()),
                   "share": float(diff.float().mean()), "max_abs": err}
            note = ""
            if k == "f1":
                # the step is unchanged, so only the sites' cells may move
                rec["off_sites"] = int((diff & ~a["set"][None]).sum())
                note = (f", {rec['off_sites']} of them off the cells whose "
                        f"site masks are set"
                        f"{'' if rec['off_sites'] == 0 else '  DIFFERS'}")
            elif k == "f0" or case in bench:
                note = "" if rec["differing"] == 0 else "  DIFFERS"
            codes[f"{case} {k}"] = rec
            print(f"{where}, {what}, final {k[0]}: {rec['differing']} of "
                  f"{diff.numel()} stored codes differ between the checkouts "
                  f"(share {rec['share']:.2e}, max decoded difference "
                  f"{err:.3e}){note}", flush=True)
    for pt in sorted((tmp / "this").glob("K-AVG *.pt")):
        a, b = (torch.load(tmp / tag / pt.name) for tag in ("other", "this"))
        diff = {k: int((a[k].view(torch.int32) != b[k].view(torch.int32)).sum())
                for k in a}
        codes[pt.stem] = diff
        print(f"{pt.stem} {CODES_SHAPE} 3 samples: differing accumulator bits "
              f"between the checkouts {diff}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
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
    for name in sorted(set(regs["other"]) - set(regs["this"])):
        print(f"{name} (the other checkout only): {regs['other'][name]} "
              f"registers, {sizes['other'].get(name)} SASS instructions")
    steps = [k for k in same if k.startswith("stream_collide_tiled")]
    kept = [k for k in steps if (regs["other"][k], sizes["other"].get(k))
            == (regs["this"][k], sizes["this"].get(k))]
    print(f"K-SC instances: {len(kept)} of {len(steps)} shared ones keep "
          f"their registers and SASS instruction counts"
          + ("" if len(kept) == len(steps) else
             f"; differ: {sorted(set(steps) - set(kept))}"), flush=True)
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
