"""The split path across four NVIDIA cards, and nothing else.

    python3 chip_four.py

With shard i on card i (`device="cuda"`, the device rule of
`latticeurbanwind_tpu_torch/parallel/mesh.py`), through `chip_smoke.py`'s
own checks: the sharded runner against the single-device kernel over the
splits four cards take ((1,1,2), (1,2,2), (2,1,1); equal stored codes),
and the example profile deck at 1.5 m split `n_gpu = [1, 2, 2]` against the
unsplit deck on card 0 (final DDFs and raw VTKs equal, averages within the
fused pass's tolerance), with each card's peak memory and the split step's
time; then the same split deck over processes, NCCL between them
(`parallel/comm.py`): 4 processes with one card each and 2 processes with
two cards each (`CUDA_VISIBLE_DEVICES`, the port's `cli.run --device cuda`
in each, `chip_smoke.run_deck_processes`), each run's VTKs byte for byte
and its final DDFs code for code the single-process run's on four cards,
with each card's peak memory and the split step's ms (whole, exchange, K8
launches, refresh); then the `.luwdg` example at 2 m with four angles
case-parallel, one case per card, each case's files byte for byte those of
its serial run on card 0, with the wall seconds of both.  Exits non-zero
with fewer than four cards or on any disagreement.
"""
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402



def over_processes(work: Path, spread: dict) -> dict:
    """The split deck (`spread`: its one-process run on four cards, kept)
    over processes with NCCL between them: 4 processes x 1 card and 2
    processes x 2 cards, each held to `spread` (final DDFs by digest, VTKs
    byte for byte); each process's launches, each card's peak memory, the
    split step's ms.  Both configurations run even if one fails."""
    digest = c.fi_digest(spread["fi"])
    vtks = {k: v for k, v in spread["files"].items() if k.endswith(".vtk")}
    out, failed = {}, {}
    for tag, n, cards in (("nccl-4x1", 4, ("0", "1", "2", "3")),
                          ("nccl-2x2", 2, ("0,1", "2,3"))):
        try:
            run = c.run_deck_processes(
                work, work / "vk-bf16-sharded-4cards", tag, device="cuda", n=n,
                env_of=lambda k, cards=cards: {"CUDA_VISIBLE_DEVICES": cards[k]})
        except AssertionError as e:       # the other configuration still runs
            c.log(f"[{tag}] FAILED: {e}")
            failed[tag] = str(e)[:200]
            continue
        records = [p["record"] for p in run["processes"]]
        for k, p in enumerate(run["processes"]):
            shards = len(p["record"]["shards"])
            c.log(f"[{tag}] process {k} on cards {cards[k]} (shards "
                  f"{p['record']['shards']} on {p['record']['devices']}, data "
                  f"over {p['record']['backend']}): launches {p['launches']}; "
                  f"peak memory per visible card (GiB) {p['record']['peak_gib']}")
            if (p["record"]["backend"] != "nccl"
                    or p["launches"]["stream_collide_halo"] != 400 * shards):
                raise AssertionError(f"[{tag}] process {k}: {p['record']}, "
                                     f"{p['launches']}")
        same = {k: run["vtks"][k].read_bytes() == v.read_bytes()
                for k, v in vtks.items()} if sorted(run["vtks"]) == sorted(vtks) else {}
        fi_same = records[0]["fi_sha256"] == digest
        c.log(f"[{tag}] against vk-bf16-sharded-4cards: final DDFs "
              f"{'equal' if fi_same else 'DIFFER'}, VTKs " + ", ".join(
                  f"{k} {'byte for byte' if v else 'DIFFER'}" for k, v in same.items()))
        if not (fi_same and same and all(same.values())):
            raise AssertionError(f"[{tag}] the run differs from the one-process run")
        c.log(f"[{tag}] split step, ms per step (host clock, in lock-step) by "
              f"process: whole {[r['step_ms'] for r in records]}, exchange "
              f"{[r['exchange_ms'] for r in records]}, K8 launches "
              f"{[r['kernels_ms'] for r in records]}, refresh "
              f"{[r['refresh_ms'] for r in records]}; bytes staged through the "
              f"host per step {[r['staged_bytes_per_step'] for r in records]}; "
              f"solver seconds {[round(r['solver_seconds'], 2) for r in records]}, "
              f"{records[0]['mlups']:.0f} MLUPs; processes' wall {run['wall']:.1f} s")
        out[tag] = records
        shutil.rmtree(run["case"], ignore_errors=True)
    if failed:
        raise AssertionError(f"deck runs over processes failed: {failed}")
    return out


def spread_deck(work: Path) -> dict:
    """The split deck in one process, shard i on card i, kept."""
    for i in range(4):
        torch.cuda.reset_peak_memory_stats(i)
    spread = c.run_example_deck(work, "vk-bf16-sharded-4cards", storage="bf16",
                                steps=400, vk=True, n_gpu=c.SHARD_SPLIT,
                                device="cuda", keep=True)
    c.log("peak device memory per card (GiB): "
          + ", ".join(f"{torch.cuda.max_memory_allocated(i) / 2**30:.2f}"
                      for i in range(4)))
    return spread


def main() -> None:
    t0 = time.time()
    c.phase_card()
    assert torch.cuda.device_count() >= 4, torch.cuda.device_count()
    c.SHARD_DEVICE = "cuda"
    c.SPLITS = ((1, 1, 2), (1, 2, 2), (2, 1, 1))
    c.log(f"sharded runner across cards: {c.compare_sharded()}")
    work = Path(tempfile.mkdtemp(prefix="four_", dir=HERE))
    try:
        unsplit = c.run_example_deck(work, "vk-bf16-400", storage="bf16",
                                     steps=400, vk=True, keep=True)
        spread = spread_deck(work)
        c.log(f"against unsplit: {c.compare_split_deck(spread, unsplit, 'vk-bf16-sharded-4cards')}")
        c.log(f"sharded loop: {spread['sharded_loop']}; solver {spread['solver_seconds']:.2f} s, "
              f"{spread['mlups']:.0f} MLUPs; unsplit solver {unsplit['solver_seconds']:.2f} s, "
              f"{unsplit['mlups']:.0f} MLUPs")
        del unsplit
        torch.cuda.empty_cache()
        over_processes(work, spread)
        del spread
        torch.cuda.empty_cache()
        dg = c.run_datagen_deck(work, "dg-bf16-300-4cards", storage="bf16",
                                steps=300, cases=4, device="cuda",
                                angles=(0.0, 45.0, 90.0, 135.0))
        c.log(f"case-parallel over {dg['devices']} cards: whole run_deck "
              f"{dg['wall']:.1f} s against {dg['serial_wall']:.1f} s serial on card 0; "
              f"solver seconds per case {dg['solver_seconds']}")
        if dg["devices"] != 4:
            raise AssertionError(f"case-parallel ran on {dg['devices']} cards")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    c.log(f"four-card call seconds {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
