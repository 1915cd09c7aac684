// Element-wise entry points of the storage codecs (codec.cuh), so that the
// codecs the kernels run can be held bit for bit against the torch codecs
// of lbm/state.py on the card.  Not on the solver's path: the kernels inline
// the same functions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"

namespace {

constexpr int kThreads = 256;

template <class C>
__global__ void encode_kernel(const float* __restrict__ x,
                              typename C::T* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = C::enc(x[i]);
}

template <class C>
__global__ void decode_kernel(const typename C::T* __restrict__ bits,
                              float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = C::load(bits, i);
}

unsigned int grid(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <class C>
cudaError_t encode(const void* x, void* out, long long n, cudaStream_t st) {
  encode_kernel<C><<<grid(n), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<typename C::T*>(out), n);
  return cudaGetLastError();
}

template <class C>
cudaError_t decode(const void* bits, void* out, long long n, cudaStream_t st) {
  decode_kernel<C><<<grid(n), kThreads, 0, st>>>(
      static_cast<const typename C::T*>(bits), static_cast<float*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// storage: 0 = f32, 1 = bf16, 2 = f16 (FP16S), 3 = fp16c.  Launch on
// `stream` without synchronising; return cudaGetLastError() (0 on success).
extern "C" int luw_codec_encode(const void* x, void* out, long long n,
                                int storage, void* stream) {
  if (n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return (int)encode<luw::CodecF32>(x, out, n, st);
    case 1: return (int)encode<luw::CodecBF16>(x, out, n, st);
    case 2: return (int)encode<luw::CodecF16>(x, out, n, st);
    case 3: return (int)encode<luw::CodecFP16C>(x, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int luw_codec_decode(const void* bits, void* out, long long n,
                                int storage, void* stream) {
  if (n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return (int)decode<luw::CodecF32>(bits, out, n, st);
    case 1: return (int)decode<luw::CodecBF16>(bits, out, n, st);
    case 2: return (int)decode<luw::CodecF16>(bits, out, n, st);
    case 3: return (int)decode<luw::CodecFP16C>(bits, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
