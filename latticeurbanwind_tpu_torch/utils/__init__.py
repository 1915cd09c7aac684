"""Build and environment helpers: the CUDA kernel builder, the native C++
helpers and the luwenv probe."""
