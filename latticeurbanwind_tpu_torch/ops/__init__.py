"""The CUDA kernels' Python wrappers and their plain torch versions."""
