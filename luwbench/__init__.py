"""The benchmark of the PyTorch and CUDA port (`latticeurbanwind_tpu_torch`).

`run.py` is the command that `BENCHMARK.json` names; `harness.py` drives
one run of a cell from its data files (`configs/`, `workloads/`,
`metrics/`); `check.py` and `reference/` decide `correct`; `counts.py`
holds the frozen work counts and the card's published peaks; `trace.py`
reduces the profiler's trace.  Nothing here imports JAX or the JAX package.
"""
