"""The split path across four NVIDIA cards, and nothing else.

    python3 chip_four.py

With shard i on card i (`device="cuda"`, the device rule of
`latticeurbanwind_tpu_torch/parallel/mesh.py`), through `chip_smoke.py`'s
own checks: the sharded runner against the single-device kernel over the
splits four cards take ((1,1,2), (1,2,2), (2,1,1); equal stored codes),
and the example profile deck at 1.5 m split `n_gpu = [1, 2, 2]` against the
unsplit deck on card 0 (final DDFs and raw VTKs equal, averages within the
fused pass's tolerance), with each card's peak memory and the split step's
time; then the `.luwdg` example at 2 m with four angles case-parallel, one
case per card, each case's files byte for byte those of its serial run on
card 0, with the wall seconds of both.  Exits non-zero with fewer than four
cards or on any disagreement.
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

t0 = time.time()
c.phase_card()
assert torch.cuda.device_count() >= 4, torch.cuda.device_count()
c.SHARD_DEVICE = "cuda"
c.SPLITS = ((1, 1, 2), (1, 2, 2), (2, 1, 1))
c.log(f"sharded runner across cards: {c.compare_sharded()}")
work = Path(tempfile.mkdtemp(prefix="four_", dir=HERE))
try:
    main = c.run_example_deck(work, "vk-bf16-400", storage="bf16", steps=400,
                              vk=True, keep=True)
    for i in range(4):
        torch.cuda.reset_peak_memory_stats(i)
    spread = c.run_example_deck(work, "vk-bf16-sharded-4cards", storage="bf16",
                                steps=400, vk=True, n_gpu=c.SHARD_SPLIT,
                                device="cuda", keep=True)
    c.log("peak device memory per card (GiB): "
          + ", ".join(f"{torch.cuda.max_memory_allocated(i) / 2**30:.2f}"
                      for i in range(4)))
    c.log(f"against unsplit: {c.compare_split_deck(spread, main, 'vk-bf16-sharded-4cards')}")
    c.log(f"sharded loop: {spread['sharded_loop']}; solver {spread['solver_seconds']:.2f} s, "
          f"{spread['mlups']:.0f} MLUPs; unsplit solver {main['solver_seconds']:.2f} s, "
          f"{main['mlups']:.0f} MLUPs")
    del main, spread
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
