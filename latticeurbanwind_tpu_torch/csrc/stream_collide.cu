// Fused D3Q19 stream-collide step for Hopper (sm_90a), one thread per cell,
// instantiated for every storage codec behind one C entry point.
//
// Replaces: latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step,
// the Pallas TPU kernel that advances the lattice by one time step.  This
// kernel computes the same stages for the configurations the profile-mode
// solve runs: pull streaming with halfway bounce-back from solid sources,
// moments, global force + Coriolis, buffer nudging and the top sponge toward
// the FaceBC targets, the Guo half-step clamped to +-CS, equilibrium plus
// Guo source, the Smagorinsky effective relaxation rate, SRT collision, the
// TYPE_E freeze (equilibrium cells write their stored values back) and
// TYPE_S zeroing; a second kernel applies the VK inlet sites (below).
// Storage is any codec of codec.cuh (f32, bf16, f16, fp16c) in the
// (19, Z, Y, X) SoA layout of LBMState.fi; the wrap is periodic on all three
// axes like the reference's modular neighbour indexing.
//
// VK inlet sites (the Pallas kernel's `vk` spec, make_pallas_step
// :915-978): at the boundary faces that carry a site mask, the cell's
// encoded outputs are overwritten by enc(m * feq_vk(u_face) + (1 - m) *
// dec(out)), where feq_vk is the DDF-shifted equilibrium at rho = 1 of the
// FaceBC velocity at that face cell and m the site's 0/1 mask.  Sites apply
// in the Pallas order -- planes (ut at z = Z-1, ub at z = 0), then rows (us
// at y = 0, un at y = Y-1), then lanes (uw at x = 0, ue at x = X-1) -- each
// reading back the output the earlier ones left, so the west and east lanes
// own the corners.  The Pallas kernel applies them in its epilogue; here
// they are a face pass launched right after the step on the same stream,
// one thread per cell of the domain's boundary shell, which reads the
// step's stored outputs and overwrites them -- the same values, since the
// epilogue too reads back encoded outputs.  The pass leaves the step kernel
// as it is and costs ~0.21 ms per step at 21.2M cells in every storage
// (+11% fp16c to +16% bf16 on the H100; the x = 0 and x = X-1 lanes touch
// one element per 32-byte sector).  Inside the step the sites cost +14%
// (bf16) to +72% (fp16c) fused (96 and more registers against 72, and the
// fp16c blend's code crowding the instruction cache), and +2% (f32) to
// +64% (fp16c) as a __noinline__ tail call.
//
// Bound on the H100: device memory.  A cell update reads 19 DDFs and writes
// 19 (2*19*sizeof(storage) bytes) plus its flag byte -- 77 B for the 2-byte
// storages, 153 B for f32 -- plus 5 B of nudge fields when nudging is on;
// the ~300 flops per cell (and the few integer ops of a software codec) are
// far below the card's compute roof at that traffic.  The VK site pass
// touches only the boundary shell, O(N^(2/3)) cells.
//
// Design: threads run along x (the innermost axis) so every warp load and
// store of a DDF channel is one coalesced line; the 18 pulled neighbours of
// a thread are the same channels shifted by one row/plane, so a warp's pull
// reads are coalesced too, and neighbour reuse comes from L1/L2 rather than
// shared memory.  Own values are read only where needed (bounce-back
// opposites, the TYPE_E freeze), and solid / TYPE_E cells skip the
// arithmetic.  Offsets are 64-bit: 19 channels of a 134M-cell grid exceed
// 2^31 elements.  Shared-memory tiling and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"

namespace luw {

constexpr uint8_t kTypeS = 0x01;
constexpr uint8_t kTypeE = 0x02;
constexpr float kCs = 0.57735027f;
constexpr float kSmagorinsky = 0.76421222f;
constexpr int kScThreads = 128;

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

// One VK site: o <- enc(m * feq_vk(u) + (1 - m) * dec(o)).  feq_vk is the
// DDF-shifted D3Q19 equilibrium at rho = 1 in the Pallas evaluation order
// (c.u over nonzero terms, opposite pairs sharing b +- w*cu).
template <class C>
__device__ __forceinline__ void vk_blend(typename C::T (&o)[19], float m,
                                         float ux, float uy, float uz) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  const float W[19] = {1.f / 3.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f};
  const float c3 = -3.0f * (ux * ux + uy * uy + uz * uz);
  float fe[19];
  fe[0] = (1.0f / 3.0f) * (0.5f * c3);
#pragma unroll
  for (int d = 1; d < 19; d += 2) {
    const float cu = 3.0f * cdot(CX[d], CY[d], CZ[d], ux, uy, uz);
    const float b = W[d] * (0.5f * (cu * cu + c3));
    fe[d] = b + W[d] * cu;
    fe[OPP[d]] = b - W[d] * cu;
  }
  const float om = 1.0f - m;
#pragma unroll
  for (int d = 0; d < 19; ++d) o[d] = C::enc(m * fe[d] + om * C::dec(o[d]));
}

// The site masks: null where the face carries no site.  Lane masks are
// (Z, 1, Y), row masks (Z, 1, X), plane masks (Y, X), all f32.
struct VkMasks {
  const float* uw;
  const float* ue;
  const float* us;
  const float* un;
  const float* ut;
  const float* ub;
};

__device__ __forceinline__ bool vk_on_site(const VkMasks& vm, int z, int y,
                                           int x, int Z, int Y, int X) {
  return (z == Z - 1 && vm.ut) || (z == 0 && vm.ub) || (y == 0 && vm.us) ||
         (y == Y - 1 && vm.un) || (x == 0 && vm.uw) || (x == X - 1 && vm.ue);
}

// Every site of the cell in the Pallas order: planes, rows, lanes.
template <class C>
__device__ __forceinline__ void vk_sites(
    typename C::T (&o)[19], const VkMasks& vm, int z, int y, int x, int Z,
    int Y, int X, const float* __restrict__ uw, const float* __restrict__ ue,
    const float* __restrict__ us, const float* __restrict__ un,
    const float* __restrict__ ut, const float* __restrict__ ub) {
  const long long plane = (long long)Y * X;
  const long long yx = (long long)y * X + x;
  if (z == Z - 1 && vm.ut)
    vk_blend<C>(o, vm.ut[yx], ut[yx], ut[plane + yx], ut[2 * plane + yx]);
  if (z == 0 && vm.ub)
    vk_blend<C>(o, vm.ub[yx], ub[yx], ub[plane + yx], ub[2 * plane + yx]);
  const long long zx = (long long)z * X + x;
  const long long rx = (long long)z * 3 * X + x;
  if (y == 0 && vm.us)
    vk_blend<C>(o, vm.us[zx], us[rx], us[rx + X], us[rx + 2 * X]);
  if (y == Y - 1 && vm.un)
    vk_blend<C>(o, vm.un[zx], un[rx], un[rx + X], un[rx + 2 * X]);
  const long long zy = (long long)z * Y + y;
  const long long ry = (long long)z * 3 * Y + y;
  if (x == 0 && vm.uw)
    vk_blend<C>(o, vm.uw[zy], uw[ry], uw[ry + Y], uw[ry + 2 * Y]);
  if (x == X - 1 && vm.ue)
    vk_blend<C>(o, vm.ue[zy], ue[ry], ue[ry + Y], ue[ry + 2 * Y]);
}

template <class C, bool kForce, bool kNudge, bool kSponge>
__global__ void __launch_bounds__(kScThreads)
stream_collide_kernel(const typename C::T* __restrict__ fa,
                      typename C::T* __restrict__ fb,
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
    for (int d = 0; d < 19; ++d) fb[d * N + n] = C::enc(0.0f);
    return;
  }
  if (fl & kTypeE) {  // frozen equilibrium: the stored bits go back unchanged
#pragma unroll
    for (int d = 0; d < 19; ++d) fb[d * N + n] = fa[d * N + n];
    return;
  }

  // ---- pull streaming with halfway bounce-back from solid sources ----
  float f[19];
  f[0] = C::load(fa, n);
#pragma unroll
  for (int d = 1; d < 19; ++d) {
    const int xs = wrap(x - CX[d], X);
    const int ys = wrap(y - CY[d], Y);
    const int zs = wrap(z - CZ[d], Z);
    const long long src = ((long long)zs * Y + ys) * X + xs;
    f[d] = (flags[src] & kTypeS) ? C::load(fa, (long long)OPP[d] * N + n)
                                 : C::load(fa, (long long)d * N + src);
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
    fb[d * N + n] = C::enc(coll);
  }
}

// The VK site pass over the boundary shell of the (Z, Y, X) box, one thread
// per cell: the z = 0 and z = Z-1 planes, then the y = 0 and y = Y-1 rows of
// the interior z, then the x = 0 and x = X-1 lanes of the interior z and y
// (a box thinner than 3 cells lists each of its cells once).  A cell on a
// masked face gets all of its sites, in order, from the step's outputs.
template <class C>
__global__ void __launch_bounds__(kScThreads)
vk_site_kernel(typename C::T* __restrict__ fb, VkMasks vm,
               const float* __restrict__ uw, const float* __restrict__ ue,
               const float* __restrict__ us, const float* __restrict__ un,
               const float* __restrict__ ut, const float* __restrict__ ub,
               int Z, int Y, int X) {
  using T = typename C::T;
  const int Zi = max(Z - 2, 0), Yi = max(Y - 2, 0);
  const long long nP = (long long)Y * X, nR = (long long)Zi * X,
                  nL = (long long)Zi * Yi;
  const long long sP = min(Z, 2) * nP, sR = min(Y, 2) * nR,
                  sL = min(X, 2) * nL;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int z, y, x;
  if (i < sP) {
    z = i < nP ? 0 : Z - 1;
    i %= nP;
    y = (int)(i / X);
    x = (int)(i % X);
  } else if ((i -= sP) < sR) {
    y = i < nR ? 0 : Y - 1;
    i %= nR;
    z = 1 + (int)(i / X);
    x = (int)(i % X);
  } else if ((i -= sR) < sL) {
    x = i < nL ? 0 : X - 1;
    i %= nL;
    z = 1 + (int)(i / Yi);
    y = 1 + (int)(i % Yi);
  } else {
    return;
  }
  if (!vk_on_site(vm, z, y, x, Z, Y, X)) return;
  const long long N = (long long)Z * Y * X;
  const long long n = ((long long)z * Y + y) * X + x;
  T o[19];
#pragma unroll
  for (int d = 0; d < 19; ++d) o[d] = fb[d * N + n];
  vk_sites<C>(o, vm, z, y, x, Z, Y, X, uw, ue, us, un, ut, ub);
#pragma unroll
  for (int d = 0; d < 19; ++d) fb[d * N + n] = o[d];
}

// Host-side arguments of one step (pointers already typed by the entry).
struct ScArgs {
  const void* fa;
  void* fb;
  const uint8_t* flags;
  const float* dyn;
  const float* nudge_sigma;
  const uint8_t* nudge_face;
  const float *uw, *ue, *us, *un, *ut, *ub;
  const float* sponge_z;
  VkMasks vm;
  int Z, Y, X;
  int volume_force, has_nudge, has_sponge, nudge_vertical, subgrid;
  float omega, tau0, tau0_sq;
};

template <class C, bool kForce, bool kNudge, bool kSponge>
cudaError_t sc_launch(const ScArgs& a, cudaStream_t stream) {
  using T = typename C::T;
  const long long cells = (long long)a.Z * a.Y * a.X;
  const unsigned int blocks =
      (unsigned int)((cells + kScThreads - 1) / kScThreads);
  stream_collide_kernel<C, kForce, kNudge, kSponge>
      <<<blocks, kScThreads, 0, stream>>>(
          static_cast<const T*>(a.fa), static_cast<T*>(a.fb), a.flags, a.dyn,
          a.nudge_sigma, a.nudge_face, a.uw, a.ue, a.us, a.un, a.ut, a.ub,
          a.sponge_z, a.Z, a.Y, a.X, a.nudge_vertical, a.subgrid, a.omega,
          a.tau0, a.tau0_sq);
  return cudaGetLastError();
}

template <class C>
cudaError_t sc_dispatch_force(const ScArgs& a, cudaStream_t stream) {
  if (!a.volume_force) {
    if (a.has_nudge || a.has_sponge) return cudaErrorInvalidValue;
    return sc_launch<C, false, false, false>(a, stream);
  }
  if (a.has_nudge && a.has_sponge)
    return sc_launch<C, true, true, true>(a, stream);
  if (a.has_nudge) return sc_launch<C, true, true, false>(a, stream);
  if (a.has_sponge) return sc_launch<C, true, false, true>(a, stream);
  return sc_launch<C, true, false, false>(a, stream);
}

// One step in storage codec C, then the VK site pass when any mask is
// given.
template <class C>
cudaError_t sc_dispatch(const ScArgs& a, cudaStream_t stream) {
  const cudaError_t err = sc_dispatch_force<C>(a, stream);
  const VkMasks& m = a.vm;
  if (err != cudaSuccess || !(m.uw || m.ue || m.us || m.un || m.ut || m.ub))
    return err;
  const long long Zi = a.Z > 2 ? a.Z - 2 : 0, Yi = a.Y > 2 ? a.Y - 2 : 0;
  const long long shell = (a.Z > 1 ? 2 : 1) * (long long)a.Y * a.X +
                          (a.Y > 1 ? 2 : 1) * Zi * a.X +
                          (a.X > 1 ? 2 : 1) * Zi * Yi;
  const unsigned int blocks =
      (unsigned int)((shell + kScThreads - 1) / kScThreads);
  vk_site_kernel<C><<<blocks, kScThreads, 0, stream>>>(
      static_cast<typename C::T*>(a.fb), a.vm, a.uw, a.ue, a.us, a.un, a.ut,
      a.ub, a.Z, a.Y, a.X);
  return cudaGetLastError();
}

}  // namespace luw

// storage: 0 = f32, 1 = bf16, 2 = f16 (FP16S), 3 = fp16c.  mask_* are the VK
// inlet site masks (null where a face carries no site; all null launches
// the VK-off kernel).  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int luw_stream_collide(
    const void* fa, void* fb, const void* flags, const void* dyn,
    const void* nudge_sigma, const void* nudge_face, const void* uw,
    const void* ue, const void* us, const void* un, const void* ut,
    const void* ub, const void* sponge_z, const void* mask_uw,
    const void* mask_ue, const void* mask_us, const void* mask_un,
    const void* mask_ut, const void* mask_ub, int Z, int Y, int X,
    int storage, int volume_force, int has_nudge, int has_sponge,
    int nudge_vertical, int subgrid, float omega, float tau0, float tau0_sq,
    void* stream) {
  using luw::ScArgs;
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  ScArgs a;
  a.fa = fa;
  a.fb = fb;
  a.flags = static_cast<const uint8_t*>(flags);
  a.dyn = F(dyn);
  a.nudge_sigma = F(nudge_sigma);
  a.nudge_face = static_cast<const uint8_t*>(nudge_face);
  a.uw = F(uw);
  a.ue = F(ue);
  a.us = F(us);
  a.un = F(un);
  a.ut = F(ut);
  a.ub = F(ub);
  a.sponge_z = F(sponge_z);
  a.vm = {F(mask_uw), F(mask_ue), F(mask_us), F(mask_un), F(mask_ut),
          F(mask_ub)};
  a.Z = Z;
  a.Y = Y;
  a.X = X;
  a.volume_force = volume_force;
  a.has_nudge = has_nudge;
  a.has_sponge = has_sponge;
  a.nudge_vertical = nudge_vertical;
  a.subgrid = subgrid;
  a.omega = omega;
  a.tau0 = tau0;
  a.tau0_sq = tau0_sq;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (storage) {
    case 0: err = luw::sc_dispatch<luw::CodecF32>(a, st); break;
    case 1: err = luw::sc_dispatch<luw::CodecBF16>(a, st); break;
    case 2: err = luw::sc_dispatch<luw::CodecF16>(a, st); break;
    case 3: err = luw::sc_dispatch<luw::CodecFP16C>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
