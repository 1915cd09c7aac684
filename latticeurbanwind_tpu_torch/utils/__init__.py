"""Build helpers: the CUDA kernel builder and the native C++ helpers."""
