// Fused D3Q19 stream-collide step for Hopper (sm_90a), one thread per cell.
//
// Replaces: latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step,
// the Pallas TPU kernel that advances the lattice by one time step.  This
// kernel computes the same stages for the configurations the profile-mode
// solve runs: pull streaming with halfway bounce-back from solid sources,
// moments, global force + Coriolis, buffer nudging and the top sponge toward
// the static FaceBC targets, the Guo half-step clamped to +-CS, equilibrium
// plus Guo source, the Smagorinsky effective relaxation rate, SRT collision,
// the TYPE_E freeze (equilibrium cells write their stored values back) and
// TYPE_S zeroing.  Storage is f32 or bf16 in the (19, Z, Y, X) SoA layout of
// LBMState.fi; the wrap is periodic on all three axes like the reference's
// modular neighbour indexing.
//
// Bound on the H100: device memory.  A cell update reads 19 DDFs and writes
// 19 (2*19*sizeof(storage) bytes) plus its flag byte -- 77 B for bf16,
// 153 B for f32 -- plus 5 B of nudge fields when nudging is on; the ~300
// flops per cell are far below the card's compute roof at that traffic.
//
// Design: threads run along x (the innermost axis) so every warp load and
// store of a DDF channel is one coalesced 128-byte line; the 18 pulled
// neighbours of a thread are the same channels shifted by one row/plane,
// so a warp's pull reads are coalesced too, and neighbour reuse comes from
// L1/L2 rather than shared memory.  Own values are read only where needed
// (bounce-back opposites, the TYPE_E freeze), and solid / TYPE_E cells skip
// the arithmetic.  Offsets are 64-bit: 19 channels of a 134M-cell grid
// exceed 2^31 elements.  Shared-memory tiling and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint8_t kTypeS = 0x01;
constexpr uint8_t kTypeE = 0x02;
constexpr float kCs = 0.57735027f;
constexpr float kSmagorinsky = 0.76421222f;
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

template <typename S>
__device__ __forceinline__ S encode(float v);
template <>
__device__ __forceinline__ float encode<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 encode<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float clamp_cs(float v) {
  return fminf(fmaxf(v, -kCs), kCs);
}

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// c.v for a lattice direction, summing only its nonzero components in x, y,
// z order (the reference kernels' evaluation order)
__device__ __forceinline__ float cdot(int cx, int cy, int cz, float a, float b,
                                      float c) {
  return (cx ? cx * a : 0.0f) + (cy ? cy * b : 0.0f) + (cz ? cz * c : 0.0f);
}

// Face targets of the nudging band (FaceBC layouts: uw/ue (Z,3,Y),
// us/un (Z,3,X), ut/ub (3,Y,X)); face ids 1..5 pick ue, us, un, ut, ub and
// anything else the west face.
__device__ __forceinline__ float face_target(
    int face, int a, int z, int y, int x, int Y, int X,
    const float* __restrict__ uw, const float* __restrict__ ue,
    const float* __restrict__ us, const float* __restrict__ un,
    const float* __restrict__ ut, const float* __restrict__ ub) {
  const long long zy = ((long long)z * 3 + a) * Y + y;
  const long long zx = ((long long)z * 3 + a) * X + x;
  const long long yx = ((long long)a * Y + y) * X + x;
  switch (face) {
    case 1: return ue[zy];
    case 2: return us[zx];
    case 3: return un[zx];
    case 4: return ut[yx];
    case 5: return ub[yx];
    default: return uw[zy];
  }
}

template <typename S, bool kForce, bool kNudge, bool kSponge>
__global__ void __launch_bounds__(kThreads)
stream_collide_kernel(const S* __restrict__ fa, S* __restrict__ fb,
                      const uint8_t* __restrict__ flags,
                      const float* __restrict__ dyn,
                      const float* __restrict__ nudge_sigma,
                      const uint8_t* __restrict__ nudge_face,
                      const float* __restrict__ uw, const float* __restrict__ ue,
                      const float* __restrict__ us, const float* __restrict__ un,
                      const float* __restrict__ ut, const float* __restrict__ ub,
                      const float* __restrict__ sponge_z, int Z, int Y, int X,
                      int nudge_vertical, int subgrid, float omega, float tau0,
                      float tau0_sq) {
  // cz-grouped D3Q19 order of latticeurbanwind_tpu/lbm/lattice.py
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  const float W[19] = {1.f / 3.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f};

  const long long N = (long long)Z * Y * X;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int x = (int)(n % X);
  const long long zy = n / X;
  const int y = (int)(zy % Y);
  const int z = (int)(zy / Y);

  const uint8_t fl = flags[n];
  if (fl & kTypeS) {
#pragma unroll
    for (int d = 0; d < 19; ++d) fb[d * N + n] = encode<S>(0.0f);
    return;
  }
  if (fl & kTypeE) {  // frozen equilibrium: the stored bits go back unchanged
#pragma unroll
    for (int d = 0; d < 19; ++d) fb[d * N + n] = fa[d * N + n];
    return;
  }

  // ---- pull streaming with halfway bounce-back from solid sources ----
  float f[19];
  f[0] = load(fa, n);
#pragma unroll
  for (int d = 1; d < 19; ++d) {
    const int xs = wrap(x - CX[d], X);
    const int ys = wrap(y - CY[d], Y);
    const int zs = wrap(z - CZ[d], Z);
    const long long src = ((long long)zs * Y + ys) * X + xs;
    f[d] = (flags[src] & kTypeS) ? load(fa, (long long)OPP[d] * N + n)
                                 : load(fa, (long long)d * N + src);
  }

  // ---- moments ----
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
  const float inv_rho = 1.0f / rho;
  const float ux = mx * inv_rho, uy = my * inv_rho, uz = mz * inv_rho;

  // ---- forces: global + Coriolis, nudging, sponge ----
  float Fx = 0.0f, Fy = 0.0f, Fz = 0.0f;
  if (kForce) {
    const float ox = dyn[3], oy = dyn[4], oz = dyn[5];
    Fx = dyn[0] - 2.0f * rho * (oy * uz - oz * uy);
    Fy = dyn[1] - 2.0f * rho * (oz * ux - ox * uz);
    Fz = dyn[2] - 2.0f * rho * (ox * uy - oy * ux);
  }
  if (kNudge) {
    const int face = nudge_face[n];
    const float rs = rho * nudge_sigma[n];
    Fx += rs * (face_target(face, 0, z, y, x, Y, X, uw, ue, us, un, ut, ub) - ux);
    Fy += rs * (face_target(face, 1, z, y, x, Y, X, uw, ue, us, un, ut, ub) - uy);
    if (nudge_vertical)
      Fz += rs * (face_target(face, 2, z, y, x, Y, X, uw, ue, us, un, ut, ub) - uz);
  }
  if (kSponge) {
    const float rs = rho * sponge_z[z];
    const long long yx = (long long)y * X + x;
    const long long plane = (long long)Y * X;
    Fx += rs * (ut[yx] - ux);
    Fy += rs * (ut[plane + yx] - uy);
    Fz += rs * (ut[2 * plane + yx] - uz);
  }

  // ---- Guo half-step + clamp ----
  float vx, vy, vz;
  if (kForce) {
    const float half = 0.5f / rho;
    vx = clamp_cs(ux + Fx * half);
    vy = clamp_cs(uy + Fy * half);
    vz = clamp_cs(uz + Fz * half);
  } else {
    vx = clamp_cs(ux);
    vy = clamp_cs(uy);
    vz = clamp_cs(uz);
  }

  // ---- equilibrium + Guo source (opposite pairs share c.u) ----
  const float c3 = -3.0f * (vx * vx + vy * vy + vz * vz);
  const float rhom1 = rho - 1.0f;
  const float uF = kForce ? -(1.0f / 3.0f) * (vx * Fx + vy * Fy + vz * Fz) : 0.0f;
  float feq[19], fin[19];
  feq[0] = (1.0f / 3.0f) * (rhom1 + rho * (0.5f * c3));
  fin[0] = 3.0f * uF;
#pragma unroll
  for (int d = 1; d < 19; d += 2) {
    const int od = OPP[d];
    const float cu = 3.0f * cdot(CX[d], CY[d], CZ[d], vx, vy, vz);
    const float base = W[d] * (rhom1 + rho * (0.5f * (cu * cu + c3)));
    const float wcu = W[d] * rho * cu;
    feq[d] = base + wcu;
    feq[od] = base - wcu;
    if (kForce) {
      const float cF = cdot(CX[d], CY[d], CZ[d], Fx, Fy, Fz);
      const float w9 = 9.0f * W[d];
      const float cu3 = cu * (1.0f / 3.0f);
      fin[d] = w9 * (cF * (cu3 + 1.0f / 3.0f) + uF);
      fin[od] = w9 * (cF * (cu3 - 1.0f / 3.0f) + uF);
    }
  }

  // ---- Smagorinsky-Lilly effective relaxation rate ----
  float w_eff = omega;
  if (subgrid) {
    float hxx = 0.f, hyy = 0.f, hzz = 0.f, hxy = 0.f, hxz = 0.f, hyz = 0.f;
#pragma unroll
    for (int d = 1; d < 19; ++d) {
      const float q = f[d] - feq[d];
      if (CX[d] != 0) hxx += q;
      if (CY[d] != 0) hyy += q;
      if (CZ[d] != 0) hzz += q;
      if (CX[d] * CY[d] == 1) hxy += q; else if (CX[d] * CY[d] == -1) hxy -= q;
      if (CX[d] * CZ[d] == 1) hxz += q; else if (CX[d] * CZ[d] == -1) hxz -= q;
      if (CY[d] * CZ[d] == 1) hyz += q; else if (CY[d] * CZ[d] == -1) hyz -= q;
    }
    const float Q = hxx * hxx + hyy * hyy + hzz * hzz +
                    2.0f * (hxy * hxy + hxz * hxz + hyz * hyz);
    w_eff = 2.0f / (tau0 + sqrtf(tau0_sq + kSmagorinsky * sqrtf(Q) / rho));
  }

  // ---- SRT collision + storage encode ----
  const float one_m_w = 1.0f - w_eff;
  const float cfin = 1.0f - 0.5f * w_eff;
#pragma unroll
  for (int d = 0; d < 19; ++d) {
    float coll = one_m_w * f[d] + w_eff * feq[d];
    if (kForce) coll += cfin * fin[d];
    fb[d * N + n] = encode<S>(coll);
  }
}

template <typename S, bool kForce, bool kNudge, bool kSponge>
cudaError_t launch(const void* fa, void* fb, const uint8_t* flags,
                   const float* dyn, const float* nudge_sigma,
                   const uint8_t* nudge_face, const float* uw, const float* ue,
                   const float* us, const float* un, const float* ut,
                   const float* ub, const float* sponge_z, int Z, int Y, int X,
                   int nudge_vertical, int subgrid, float omega, float tau0,
                   float tau0_sq, cudaStream_t stream) {
  const long long cells = (long long)Z * Y * X;
  const unsigned int blocks = (unsigned int)((cells + kThreads - 1) / kThreads);
  stream_collide_kernel<S, kForce, kNudge, kSponge><<<blocks, kThreads, 0, stream>>>(
      static_cast<const S*>(fa), static_cast<S*>(fb), flags, dyn, nudge_sigma,
      nudge_face, uw, ue, us, un, ut, ub, sponge_z, Z, Y, X, nudge_vertical,
      subgrid, omega, tau0, tau0_sq);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(int volume_force, int has_nudge, int has_sponge,
                     const void* fa, void* fb, const uint8_t* flags,
                     const float* dyn, const float* nudge_sigma,
                     const uint8_t* nudge_face, const float* uw,
                     const float* ue, const float* us, const float* un,
                     const float* ut, const float* ub, const float* sponge_z,
                     int Z, int Y, int X, int nudge_vertical, int subgrid,
                     float omega, float tau0, float tau0_sq,
                     cudaStream_t stream) {
#define LUW_SC_ARGS                                                        \
  fa, fb, flags, dyn, nudge_sigma, nudge_face, uw, ue, us, un, ut, ub,     \
      sponge_z, Z, Y, X, nudge_vertical, subgrid, omega, tau0, tau0_sq, stream
  if (!volume_force) {
    if (has_nudge || has_sponge) return cudaErrorInvalidValue;
    return launch<S, false, false, false>(LUW_SC_ARGS);
  }
  if (has_nudge && has_sponge) return launch<S, true, true, true>(LUW_SC_ARGS);
  if (has_nudge) return launch<S, true, true, false>(LUW_SC_ARGS);
  if (has_sponge) return launch<S, true, false, true>(LUW_SC_ARGS);
  return launch<S, true, false, false>(LUW_SC_ARGS);
#undef LUW_SC_ARGS
}

}  // namespace

// storage: 0 = f32, 1 = bf16.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch (0 on success).
extern "C" int luw_stream_collide(
    const void* fa, void* fb, const void* flags, const void* dyn,
    const void* nudge_sigma, const void* nudge_face, const void* uw,
    const void* ue, const void* us, const void* un, const void* ut,
    const void* ub, const void* sponge_z, int Z, int Y, int X, int storage,
    int volume_force, int has_nudge, int has_sponge, int nudge_vertical,
    int subgrid, float omega, float tau0, float tau0_sq, void* stream) {
  const auto* fl = static_cast<const uint8_t*>(flags);
  const auto* dy = static_cast<const float*>(dyn);
  const auto* ns = static_cast<const float*>(nudge_sigma);
  const auto* nf = static_cast<const uint8_t*>(nudge_face);
  const auto* f_uw = static_cast<const float*>(uw);
  const auto* f_ue = static_cast<const float*>(ue);
  const auto* f_us = static_cast<const float*>(us);
  const auto* f_un = static_cast<const float*>(un);
  const auto* f_ut = static_cast<const float*>(ut);
  const auto* f_ub = static_cast<const float*>(ub);
  const auto* sz = static_cast<const float*>(sponge_z);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (storage == 0) {
    err = dispatch<float>(volume_force, has_nudge, has_sponge, fa, fb, fl, dy,
                          ns, nf, f_uw, f_ue, f_us, f_un, f_ut, f_ub, sz, Z, Y,
                          X, nudge_vertical, subgrid, omega, tau0, tau0_sq, st);
  } else if (storage == 1) {
    err = dispatch<__nv_bfloat16>(volume_force, has_nudge, has_sponge, fa, fb,
                                  fl, dy, ns, nf, f_uw, f_ue, f_us, f_un, f_ut,
                                  f_ub, sz, Z, Y, X, nudge_vertical, subgrid,
                                  omega, tau0, tau0_sq, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
