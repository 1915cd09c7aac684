"""The device storage codecs (`csrc/codec.cuh`) as element-wise operations.

The kernels inline these codecs; this module exposes them alone so that a
run on the card can hold them bit for bit against the torch codecs of
`lbm.state` (`encode_ddf` / `decode_ddf`), which are their plain versions.
CPU tensors take the torch codecs; CUDA tensors launch `csrc/codec.cu` or
raise.
"""

from __future__ import annotations

import torch

from ..lbm.state import decode_ddf, encode_ddf, storage_dtype
from .stream_collide import _STORAGE_CODE


def _launch(name: str, src: torch.Tensor, dst: torch.Tensor,
            storage: str) -> None:
    from ..utils.cuda_build import load_library

    for t in (src, dst):
        if t.device != src.device or not t.is_contiguous():
            raise ValueError("codec tensors must be contiguous on one device")
    lib = load_library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = getattr(lib, name)(src.data_ptr(), dst.data_ptr(), src.numel(),
                                _STORAGE_CODE[storage], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def encode(x: torch.Tensor, storage: str) -> torch.Tensor:
    """fp32 values -> storage representation."""
    if x.dtype != torch.float32:
        raise TypeError(f"encode takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return encode_ddf(x, storage)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no codec kernel for {x.device}")
    out = torch.empty(x.shape, dtype=storage_dtype(storage), device=x.device)
    _launch("luw_codec_encode", x, out, storage)
    return out


def decode(bits: torch.Tensor, storage: str) -> torch.Tensor:
    """storage representation -> fp32 values."""
    if bits.dtype != storage_dtype(storage):
        raise TypeError(f"{storage} bits must be {storage_dtype(storage)}, "
                        f"got {bits.dtype}")
    if bits.device.type == "cpu":
        return decode_ddf(bits, storage)
    if bits.device.type != "cuda":
        raise NotImplementedError(f"no codec kernel for {bits.device}")
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    _launch("luw_codec_decode", bits, out, storage)
    return out
