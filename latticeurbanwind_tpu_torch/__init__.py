"""LatticeUrbanWind on PyTorch and CUDA: the port of `latticeurbanwind_tpu`.

The package mirrors the JAX package's layout (`lbm/`, `ops/`, `run/`, `bc/`,
`cli/`) so each module's counterpart is easy to find.  Plain tensor code is
PyTorch; the two kernels of the profile-mode solve (`ops/stream_collide.py`,
`ops/avg_kernel.py`) are hand-written CUDA for Hopper in `csrc/`, built with
nvcc on first use (`utils/cuda_build.py`).  CUDA tensors take the kernels and
CPU tensors take their plain torch versions.  The package never imports jax.
"""

__version__ = "0.1.0"
