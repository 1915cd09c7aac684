// The fused D3Q19 stream-collide step (K-SC): what every instance shares --
// the per-cell work after the pull (collide_cell), the face targets of the
// nudging band, the VK site masks, the host-side arguments of one step
// (ScArgs) and the dispatch of the instance families.  The kernel itself is
// the tiled body of stream_collide_tiled.cuh, instantiated per family by
// stream_collide.cu (no wall model under SRT, and the C entry point),
// stream_collide_wall.cu (the wall models and TRT), stream_collide_thermal.cu
// (D3Q7) and stream_collide_halo.cu with stream_collide_halo_thermal.cu (the
// halo mode of a domain split over devices).
//
// Replaces: latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step,
// the Pallas TPU kernel that advances the lattice by one time step.  Stages,
// in the Pallas evaluation order: pull streaming with halfway bounce-back
// from solid sources (or the wall models' specular mirrors, lattice.cuh),
// moments, global force + Coriolis, the wall models' Schumann stress,
// buffer nudging and the top sponge toward the FaceBC targets, the Guo
// half-step clamped to +-CS, equilibrium plus Guo source, the Smagorinsky
// effective relaxation rate, SRT or TRT collision, the TYPE_E freeze
// (equilibrium cells write their stored values back) and TYPE_S zeroing.
// Storage is any codec of codec.cuh (f32, bf16, f16, fp16c) in the
// (19, Z, Y, X) SoA layout of LBMState.fi; the wrap is periodic on all three
// axes like the reference's modular neighbour indexing.
//
// Bound on the H100: device memory.  A cell update reads 19 DDFs and writes
// 19 (2*19*sizeof(storage) bytes) plus its flag byte -- 77 B for the 2-byte
// storages, 153 B for f32 -- plus 5 B of nudge fields when nudging is on;
// the ~300 flops per cell (and the few integer ops of a software codec) are
// far below the card's compute roof at that traffic.  What the tiled body
// does about the rest is in its header.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"
#include "lattice.cuh"
#include "thermal.cuh"

namespace luw {

constexpr float kSmagorinsky = 0.76421222f;

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

// The VK inlet site masks: null where the face carries no site.  Lane masks
// are (Z, 1, Y), row masks (Z, 1, X), plane masks (Y, X), all f32.
struct VkMasks {
  const float* uw;
  const float* ue;
  const float* us;
  const float* un;
  const float* ut;
  const float* ub;
};

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
  int wall, trt;  // wall: 0 none, 1 wall_model, 2 wall_sides
  float wall_cd, wall_cd_sides;
  int thermal;
  ThermArgs th;
  HaloArgs halo;  // fp null: not a halo-mode step
};

// The per-cell work of a step after the pull, for every instance of the
// tiled body (stream_collide_tiled.cuh): moments, global force +
// Coriolis, the wall stress, nudging, the sponge, the thermal sub-lattice,
// the Guo half-step, equilibrium + Guo source, the Smagorinsky rate, SRT or
// TRT collision and the encoded stores, in the Pallas evaluation order.
// f holds the pulled populations (decoded); n is the cell's offset in a
// channel (type I), (z, y, x) its coordinates.  The callers supply what
// reads flags or stores: stress(Fx, Fy, Fz, ux, uy, uz, rho) adds the wall
// models' stress, therm(ux, uy, uz) relaxes the cell's g and returns T (read
// only with kThermal), store(d, v) encodes and writes the post-collision
// f_d.
template <class C, bool kForce, int kNudge, int kSponge, bool kTrt,
          bool kThermal, class I, class Stress, class Therm, class Store>
__device__ __forceinline__ void collide_cell(
    const float (&f)[19], I n, int z, int y, int x, int Y, int X,
    const float* __restrict__ dyn, const float* __restrict__ nudge_sigma,
    const uint8_t* __restrict__ nudge_face, const float* __restrict__ uw,
    const float* __restrict__ ue, const float* __restrict__ us,
    const float* __restrict__ un, const float* __restrict__ ut,
    const float* __restrict__ ub, const float* __restrict__ sponge_z,
    int nudge_vertical, int subgrid, float omega, float tau0, float tau0_sq,
    const ThermArgs& th, const Stress& stress, const Therm& therm,
    const Store& store) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  const float W[19] = {1.f / 3.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f};

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

  // ---- forces: global + Coriolis, wall stress, nudging, sponge ----
  float Fx = 0.0f, Fy = 0.0f, Fz = 0.0f;
  if (kForce) {
    const float ox = dyn[3], oy = dyn[4], oz = dyn[5];
    Fx = dyn[0] - 2.0f * rho * (oy * uz - oz * uy);
    Fy = dyn[1] - 2.0f * rho * (oz * ux - ox * uz);
    Fz = dyn[2] - 2.0f * rho * (ox * uy - oy * ux);
    stress(Fx, Fy, Fz, ux, uy, uz, rho);
  }
  if (kNudge == 1 || (kNudge == 2 && nudge_sigma != nullptr)) {
    const int face = nudge_face[n];
    const float rs = rho * nudge_sigma[n];
    Fx += rs * (face_target(face, 0, z, y, x, Y, X, uw, ue, us, un, ut, ub) - ux);
    Fy += rs * (face_target(face, 1, z, y, x, Y, X, uw, ue, us, un, ut, ub) - uy);
    if (nudge_vertical)
      Fz += rs * (face_target(face, 2, z, y, x, Y, X, uw, ue, us, un, ut, ub) - uz);
  }
  if (kSponge == 1 || (kSponge == 2 && sponge_z != nullptr)) {
    const float rs = rho * sponge_z[z];
    const long long yx = (long long)y * X + x;
    const long long plane = (long long)Y * X;
    Fx += rs * (ut[yx] - ux);
    Fy += rs * (ut[plane + yx] - uy);
    Fz += rs * (ut[2 * plane + yx] - uz);
  }

  if (kThermal) {
    // ---- thermal D3Q7 with the streamed, unforced velocity; the Boussinesq
    // ---- term rides on the global force vector
    const float T = therm(ux, uy, uz);
    const float bterm = th.beta * (T - th.t_avg);
    Fx -= dyn[0] * bterm;
    Fy -= dyn[1] * bterm;
    Fz -= dyn[2] * bterm;
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

  if (kTrt) {
    // ---- TRT collision + storage encode: omega+ = w_eff on the even part
    // ---- of each opposite pair, omega- (magic parameter 3/16) on the odd
    const float wm = 1.0f / (0.1875f / (1.0f / w_eff - 0.5f) + 0.5f);
    const float hp = 0.5f * w_eff, hm = 0.5f * wm;
    const float ctp = 0.5f - 0.25f * w_eff, ctm = 0.5f - 0.25f * wm;
#pragma unroll
    for (int d = 0; d < 19; ++d) {
      const int od = OPP[d];
      float coll = f[d] + hp * (feq[d] - f[d] + feq[od] - f[od]) +
                   hm * (feq[d] - feq[od] - f[d] + f[od]);
      if (kForce) coll += ctp * (fin[d] + fin[od]) + ctm * (fin[d] - fin[od]);
      store(d, coll);
    }
    return;
  }

  // ---- SRT collision + storage encode ----
  const float one_m_w = 1.0f - w_eff;
  const float cfin = 1.0f - 0.5f * w_eff;
#pragma unroll
  for (int d = 0; d < 19; ++d) {
    float coll = one_m_w * f[d] + w_eff * feq[d];
    if (kForce) coll += cfin * fin[d];
    store(d, coll);
  }
}

// One step of a wall-model or TRT configuration in codec C (defined and
// instantiated for the four codecs in stream_collide_wall.cu).
template <class C>
cudaError_t sc_dispatch_wall(const ScArgs& a, cudaStream_t stream);

// One step of a thermal configuration in codec C (defined and instantiated
// for the four codecs in stream_collide_thermal.cu).
template <class C>
cudaError_t sc_dispatch_thermal(const ScArgs& a, cudaStream_t stream);

// One halo-mode step of any configuration in codec C (defined and
// instantiated for the four codecs in stream_collide_halo.cu; the thermal
// ones in stream_collide_halo_thermal.cu).
template <class C>
cudaError_t sc_dispatch_halo(const ScArgs& a, cudaStream_t stream);

template <class C>
cudaError_t sc_dispatch_halo_thermal(const ScArgs& a, cudaStream_t stream);

}  // namespace luw
