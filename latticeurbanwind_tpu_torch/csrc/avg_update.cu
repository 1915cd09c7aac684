// Fused moments + Welford averaging pass for Hopper (sm_90a), one thread per
// cell.
//
// Replaces: latticeurbanwind_tpu/ops/avg_kernel.py::make_avg_update, the
// Pallas TPU kernel run at every averaging sample.  It reproduces the moments
// of lbm/fields.py::update_fields -- the streamed pre-collision populations
// with halfway bounce-back from solid sources, the Guo half-step from the
// global force and Coriolis only (the nudge and sponge forces are left out,
// as update_fields leaves them out), clamped to +-CS; TYPE_E cells report
// the moments of their own frozen equilibria -- and then updates the Welford
// accumulators mean_u (3,Z,Y,X), m2_u (the variance trace) and mean_rho in
// place with the inv_n = 1/(n+1) the host passes in.  Solid cells hold their
// accumulators.  Storage is f32 or bf16 in the (19, Z, Y, X) SoA layout.
//
// Bound on the H100: device memory.  A sample reads 19 DDFs and the flags
// (39 B for bf16, 77 B for f32 with the neighbour reads served by L1/L2) and
// reads and writes 5 f32 accumulators (40 B): ~80-120 B per cell.
//
// Design: the same coalesced x-fastest thread layout and pull as the
// stream-collide kernel; fluid cells read only the pulled values (plus the
// own opposite where a source is solid), TYPE_E cells only their own 19.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint8_t kTypeS = 0x01;
constexpr uint8_t kTypeE = 0x02;
constexpr float kCs = 0.57735027f;
constexpr int kThreads = 128;

template <typename S>
__device__ __forceinline__ float load(const S* __restrict__ p, long long i);
template <>
__device__ __forceinline__ float load<float>(const float* __restrict__ p,
                                             long long i) {
  return __ldg(p + i);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(
    const __nv_bfloat16* __restrict__ p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float clamp_cs(float v) {
  return fminf(fmaxf(v, -kCs), kCs);
}

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
avg_update_kernel(const S* __restrict__ fi, const uint8_t* __restrict__ flags,
                  const float* __restrict__ dyn, float inv_n,
                  float* __restrict__ mean_u, float* __restrict__ m2_u,
                  float* __restrict__ mean_rho, int Z, int Y, int X) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};

  const long long N = (long long)Z * Y * X;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint8_t fl = flags[n];
  if (fl & kTypeS) return;  // solids hold their accumulators
  const int x = (int)(n % X);
  const long long zy = n / X;
  const int y = (int)(zy % Y);
  const int z = (int)(zy / Y);

  const bool eq = (fl & kTypeE) != 0;
  float f[19];
  f[0] = load(fi, n);
#pragma unroll
  for (int d = 1; d < 19; ++d) {
    if (eq) {  // TYPE_E: the cell's own frozen equilibria
      f[d] = load(fi, (long long)d * N + n);
    } else {
      const int xs = wrap(x - CX[d], X);
      const int ys = wrap(y - CY[d], Y);
      const int zs = wrap(z - CZ[d], Z);
      const long long src = ((long long)zs * Y + ys) * X + xs;
      f[d] = (flags[src] & kTypeS) ? load(fi, (long long)OPP[d] * N + n)
                                   : load(fi, (long long)d * N + src);
    }
  }

  float rho = f[0];
#pragma unroll
  for (int d = 1; d < 19; ++d) rho += f[d];
  rho += 1.0f;
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
#pragma unroll
  for (int d = 1; d < 19; ++d) {
    if (CX[d] == 1) mx += f[d]; else if (CX[d] == -1) mx -= f[d];
    if (CY[d] == 1) my += f[d]; else if (CY[d] == -1) my -= f[d];
    if (CZ[d] == 1) mz += f[d]; else if (CZ[d] == -1) mz -= f[d];
  }
  float u[3] = {mx / rho, my / rho, mz / rho};
  if (!eq) {
    const float ox = dyn[3], oy = dyn[4], oz = dyn[5];
    const float Fx = dyn[0] - 2.0f * rho * (oy * u[2] - oz * u[1]);
    const float Fy = dyn[1] - 2.0f * rho * (oz * u[0] - ox * u[2]);
    const float Fz = dyn[2] - 2.0f * rho * (ox * u[1] - oy * u[0]);
    const float half = 0.5f / rho;
    u[0] = clamp_cs(u[0] + Fx * half);
    u[1] = clamp_cs(u[1] + Fy * half);
    u[2] = clamp_cs(u[2] + Fz * half);
  }

  float m2_acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const long long i = a * N + n;
    const float mean = mean_u[i];
    const float delta = u[a] - mean;
    const float mean_new = mean + delta * inv_n;
    m2_acc += delta * (u[a] - mean_new);
    mean_u[i] = mean_new;
  }
  m2_u[n] += m2_acc;
  const float mr = mean_rho[n];
  mean_rho[n] = mr + (rho - mr) * inv_n;
}

template <typename S>
cudaError_t launch(const void* fi, const uint8_t* flags, const float* dyn,
                   float inv_n, float* mean_u, float* m2_u, float* mean_rho,
                   int Z, int Y, int X, cudaStream_t stream) {
  const long long cells = (long long)Z * Y * X;
  const unsigned int blocks = (unsigned int)((cells + kThreads - 1) / kThreads);
  avg_update_kernel<S><<<blocks, kThreads, 0, stream>>>(
      static_cast<const S*>(fi), flags, dyn, inv_n, mean_u, m2_u, mean_rho, Z,
      Y, X);
  return cudaGetLastError();
}

}  // namespace

// storage: 0 = f32, 1 = bf16.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (0 on success).
extern "C" int luw_avg_update(const void* fi, const void* flags,
                              const void* dyn, float inv_n, void* mean_u,
                              void* m2_u, void* mean_rho, int Z, int Y, int X,
                              int storage, void* stream) {
  const auto* fl = static_cast<const uint8_t*>(flags);
  const auto* dy = static_cast<const float*>(dyn);
  auto* mu = static_cast<float*>(mean_u);
  auto* m2 = static_cast<float*>(m2_u);
  auto* mr = static_cast<float*>(mean_rho);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (storage == 0) {
    err = launch<float>(fi, fl, dy, inv_n, mu, m2, mr, Z, Y, X, st);
  } else if (storage == 1) {
    err = launch<__nv_bfloat16>(fi, fl, dy, inv_n, mu, m2, mr, Z, Y, X, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
