// DDF storage codecs shared by the port's kernels: storage <-> fp32.
//
// Replaces: the kernel-internal codecs of
// latticeurbanwind_tpu/ops/stream_collide.py::_make_codec (the Pallas TPU
// kernels' f32 / bf16 / f16 / fp16c converters, also used by
// ops/avg_kernel.py::make_avg_update).  All arithmetic is fp32 whatever the
// storage; each codec is a struct with the storage type T, `load` (decode one
// element from device memory), `dec` and `enc`.  The two 2-byte codecs that
// the card converts in hardware, bf16 and f16, also take two neighbouring
// elements as one 4-byte word (the step's paired instance,
// stream_collide_tiled.cuh): `dec_lo` / `dec_hi` decode its first / second
// element, `enc2` encodes two values into one word, each rounded as `enc`
// rounds it.
//
//   * f32:   identity.
//   * bf16:  round-to-nearest-even via the native intrinsic.
//   * f16:   FP16S, IEEE half holding x * 2^15 (native __float2half_rn and
//            __half2float; the power-of-two scale is exact), as the port's
//            torch codec lbm/state.py::encode_ddf / decode_ddf.
//   * fp16c: the 1-4-11 custom float (exponent bias 15, no inf/NaN codes),
//            carried as uint16 bit patterns.  The integer formulas are those
//            of lbm/state.py::encode_fp16c / decode_fp16c, bit for bit on
//            every input: RNE by the +0x800 raw-bit add, denormals down to
//            2^-25, overflow saturating to sign | 0x7FFF.  NaN (any payload)
//            also saturates to sign | 0x7FFF, the Pallas kernel codec's
//            side; the JAX jnp formula alone would wrap payloads at or above
//            0x7FFFF800 (CUDA's canonical NaN 0x7FFFFFFF among them) to a
//            signed zero and so hide a blown-up cell.
//
// Bound: none of these is; a few integer ops per value against the bytes the
// kernels move.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace luw {

struct CodecF32 {
  using T = float;
  static __device__ __forceinline__ float load(const T* __restrict__ p,
                                               long long i) {
    return __ldg(p + i);
  }
  static __device__ __forceinline__ float dec(T v) { return v; }
  static __device__ __forceinline__ T enc(float v) { return v; }
};

struct CodecBF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(const T* __restrict__ p,
                                               long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float dec(T v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ T enc(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float dec_lo(uint32_t w) {
    return __uint_as_float(w << 16);
  }
  static __device__ __forceinline__ float dec_hi(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
  }
  static __device__ __forceinline__ uint32_t enc2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

struct CodecF16 {
  using T = __half;
  static __device__ __forceinline__ float dec(T v) {
    return __half2float(v) * (1.0f / 32768.0f);
  }
  static __device__ __forceinline__ float load(const T* __restrict__ p,
                                               long long i) {
    return dec(p[i]);
  }
  static __device__ __forceinline__ T enc(float v) {
    return __float2half_rn(v * 32768.0f);
  }
  static __device__ __forceinline__ float dec_lo(uint32_t w) {
    return dec(__ushort_as_half((unsigned short)(w & 0xFFFFu)));
  }
  static __device__ __forceinline__ float dec_hi(uint32_t w) {
    return dec(__ushort_as_half((unsigned short)(w >> 16)));
  }
  static __device__ __forceinline__ uint32_t enc2(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo * 32768.0f, hi * 32768.0f);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

struct CodecFP16C {
  using T = uint16_t;
  static __device__ __forceinline__ float dec(T code) {
    const uint32_t b = code;
    const uint32_t e = (b >> 11) & 0xFu;
    const uint32_t m = (b & 0x7FFu) << 12;
    // leading-zero count of a denormal mantissa via the exponent of float(m)
    const int v = (__float_as_int(__int2float_rn((int)m)) >> 23) & 0xFF;
    const uint32_t sgn = (b & 0x8000u) << 16;
    const uint32_t norm = ((e + 112u) << 23) | m;
    const int sh = min(max(150 - v, 0), 31);
    const uint32_t den =
        ((uint32_t)(v - 37) << 23) | ((m << sh) & 0x007FF000u);
    const uint32_t bits = sgn | (e != 0 ? norm : (m != 0 ? den : 0u));
    return __uint_as_float(bits);
  }
  static __device__ __forceinline__ float load(const T* __restrict__ p,
                                               long long i) {
    return dec(__ldg(p + i));
  }
  static __device__ __forceinline__ T enc(float x) {
    const uint32_t raw = __float_as_uint(x);
    const uint32_t b = raw + 0x800u;  // round to nearest even
    const int e = (int)((b >> 23) & 0xFFu);
    const uint32_t m = b & 0x007FFFFFu;
    const uint32_t sgn = (b >> 16) & 0x8000u;
    const uint32_t norm = (((uint32_t)(e - 112) << 11) & 0x7800u) | (m >> 12);
    const int sh = min(max(124 - e, 0), 31);
    const uint32_t den = (((0x007FF800u + m) >> sh) + 1u) >> 1;
    uint32_t h = sgn | (e > 112 ? norm : (e > 100 ? den : 0u));
    if (e > 127) h = sgn | 0x7FFFu;
    if ((raw & 0x7F800000u) == 0x7F800000u)  // inf and NaN saturate
      h = ((raw >> 16) & 0x8000u) | 0x7FFFu;
    return (T)h;
  }
};

}  // namespace luw
