// Fused moments + Welford averaging pass (K-AVG) for Hopper (sm_90a).
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
// accumulators.  With a wall model the streamed populations take its
// specular mirrors and the half-step its Schumann stress (lattice.cuh; the
// Pallas kernel's :179-192 and :218-234), as in update_fields.  Storage is
// any codec of codec.cuh (f32, bf16, f16, fp16c; the f16/fp16c decoders are
// the `dec` of the Pallas kernel's _make_codec) in the (19, Z, Y, X) SoA
// layout.
//
// Bound on the H100: device memory.  A sample reads 19 DDFs (38 B in the
// 2-byte storages, 76 B in f32) and the flags of a cell, and reads and
// writes its 5 f32 accumulators (40 B): ~80-120 B per cell; ~150 flops.
//
// Design: the march of the step's tiled body (stream_collide_tiled.cuh,
// tiled_march): 2-D blocks of a compile-time shape (LUW_TILE_AVG,
// LUW_TILE_AVG_WALL with a wall model) march over z with the flags of three planes in a shared-memory ring fetched by
// cp.async; a cell folds its 3x3x3 neighbourhood into a 27-bit solid mask,
// from which all 18 sources -- the wall models' mirror partners and the
// stress's neighbours included (solid_source_pick, wall_stress_at) -- are
// chosen before any load, and every DDF load is issued before any
// arithmetic; cell offsets are 32-bit, only the channel stride d * N is
// 64-bit, and no index is divided.  The arithmetic after the pull keeps
// its order line for line (rho, the momentum sums, the Guo half-step with
// the global force, Coriolis and the wall stress, clamp_cs, the Welford
// update): chip_compare.py holds the accumulators bit for bit against the
// parent checkout's.  The wall model is a template argument (0 none, 1
// wall_model, 2 wall_sides), so the instances without it are the plain
// pass.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "codec.cuh"
#include "lattice.cuh"
#include "stream_collide_tiled.cuh"

namespace {

using luw::clamp_cs;
using luw::kTypeE;
using luw::kTypeS;
using luw::TileShape;

// K-AVG's compile-time shapes (stream_collide_tiled.cuh): LUW_TILE_AVG
// without a wall model, LUW_TILE_AVG_WALL with one.
__host__ __device__ constexpr TileShape avg_shape(int wall) {
  return wall ? TileShape{LUW_TILE_AVG_WALL} : TileShape{LUW_TILE_AVG};
}

// One cell's sample: fl its flags, nb the solid bits of its 3x3x3
// neighbourhood (luw::nb_bit), n its offset in a channel, the o* the wrapped
// offsets of its neighbours along each axis.
template <class C, int kWall>
__device__ __forceinline__ void avg_cell(
    const typename C::T* __restrict__ fi, uint8_t fl, uint32_t nb, int n,
    long long N, int ozm, int ozp, int oym, int oyp, int oxm, int oxp,
    const float* __restrict__ dyn, float inv_n, float* __restrict__ mean_u,
    float* __restrict__ m2_u, float* __restrict__ mean_rho, float wall_cd,
    float wall_cd_sides) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  auto off = [&](int dz, int dy, int dx) {
    return (dz < 0 ? ozm : dz > 0 ? ozp : 0) + (dy < 0 ? oym : dy > 0 ? oyp : 0) +
           (dx < 0 ? oxm : dx > 0 ? oxp : 0);
  };
  auto solid = [&](int dz, int dy, int dx) -> bool {
    return (nb >> luw::nb_bit(dz, dy, dx)) & 1u;
  };
  auto at = [&](int ch, int p, int) { return ch * N + p; };

  if (fl & kTypeS) return;  // solids hold their accumulators
  const bool eq = (fl & kTypeE) != 0;
  // ---- every load issued before any arithmetic: the accumulators, and
  // ---- the pull, every element chosen from the mask
  float mean[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) mean[a] = mean_u[a * N + n];
  const float m2 = m2_u[n], mr = mean_rho[n];
  float f[19];
  f[0] = C::load(fi, n);
#pragma unroll
  for (int d = 1; d < 19; ++d) {
    long long idx = d * N + n;  // TYPE_E: the cell's own frozen equilibria
    if (!eq) {
      const int src = n + off(-CZ[d], -CY[d], -CX[d]);
      idx = d * N + src;
      if (solid(-CZ[d], -CY[d], -CX[d])) {
        if (kWall == 0) {
          idx = OPP[d] * N + n;
        } else {
          idx = luw::solid_source_pick<kWall>(
              [&](int, int dz, int dy, int dx) { return solid(dz, dy, dx); },
              at, d, n, src, -off(-CZ[d], 0, 0), -off(0, 0, -CX[d]),
              -off(0, -CY[d], 0));
        }
      }
    }
    f[d] = C::load(fi, idx);
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
    float Fx = dyn[0] - 2.0f * rho * (oy * u[2] - oz * u[1]);
    float Fy = dyn[1] - 2.0f * rho * (oz * u[0] - ox * u[2]);
    float Fz = dyn[2] - 2.0f * rho * (ox * u[1] - oy * u[0]);
    luw::wall_stress_at<kWall>(
        Fx, Fy, Fz, u[0], u[1], u[2], rho,
        [&](int dz, int dy, int dx) -> uint8_t {
          return solid(dz, dy, dx) ? kTypeS : 0;
        },
        wall_cd, wall_cd_sides);
    const float half = 0.5f / rho;
    u[0] = clamp_cs(u[0] + Fx * half);
    u[1] = clamp_cs(u[1] + Fy * half);
    u[2] = clamp_cs(u[2] + Fz * half);
  }

  float m2_acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float delta = u[a] - mean[a];
    const float mean_new = mean[a] + delta * inv_n;
    m2_acc += delta * (u[a] - mean_new);
    mean_u[a * N + n] = mean_new;
  }
  m2_u[n] = m2 + m2_acc;
  mean_rho[n] = mr + (rho - mr) * inv_n;
}

// Block (tx, ty) of avg_shape(kWall) and kz planes per block, grid (x tiles, y tiles,
// z chunks), at least min_blocks blocks per SM; the wrap is periodic on all
// three axes.
template <class C, int kWall>
__global__ void __launch_bounds__(avg_shape(kWall).tx * avg_shape(kWall).ty,
                                  avg_shape(kWall).min_blocks)
avg_update_kernel(const typename C::T* __restrict__ fi,
                  const uint8_t* __restrict__ flags,
                  const float* __restrict__ dyn, float inv_n,
                  float* __restrict__ mean_u, float* __restrict__ m2_u,
                  float* __restrict__ mean_rho, int Z, int Y, int X,
                  float wall_cd, float wall_cd_sides) {
  constexpr TileShape kShape = avg_shape(kWall);
  constexpr int TX = kShape.tx, TY = kShape.ty, kAhead = kShape.prefetch;
  const int x = blockIdx.x * TX + threadIdx.x, y = blockIdx.y * TY + threadIdx.y;
  const int z0 = blockIdx.z * kShape.kz, z1 = min(z0 + kShape.kz, Z);
  const int plane = Y * X;
  const long long N = (long long)Z * plane;
  const int oxm = x == 0 ? X - 1 : -1, oxp = x == X - 1 ? 1 - X : 1;
  const int oym = y == 0 ? (Y - 1) * X : -X, oyp = y == Y - 1 ? (1 - Y) * X : X;
  luw::tiled_march<TX, TY>(
      flags, z0, z1, Z, Y, X,
      [&](int z, bool live, uint8_t fl, uint32_t nb) {
        if (kAhead > 0 && live && z + kAhead < z1) {
          const int zq = z + kAhead;
          luw::prefetch_cell<C>(fi, (zq * Y + y) * X + x, N,
                                zq == 0 ? (Z - 1) * plane : -plane,
                                zq == Z - 1 ? (1 - Z) * plane : plane, oym,
                                oyp, oxm, oxp);
        }
        if (live) {
          avg_cell<C, kWall>(fi, fl, nb, (z * Y + y) * X + x, N,
                             z == 0 ? (Z - 1) * plane : -plane,
                             z == Z - 1 ? (1 - Z) * plane : plane, oym, oyp,
                             oxm, oxp, dyn, inv_n, mean_u, m2_u, mean_rho,
                             wall_cd, wall_cd_sides);
        }
      });
}

template <class C, int kWall>
cudaError_t launch_wall(const void* fi, const uint8_t* flags, const float* dyn,
                        float inv_n, float* mean_u, float* m2_u,
                        float* mean_rho, int Z, int Y, int X, float wall_cd,
                        float wall_cd_sides, cudaStream_t stream) {
  constexpr TileShape t = avg_shape(kWall);
  if ((long long)Z * Y * X > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((X + t.tx - 1) / t.tx, (Y + t.ty - 1) / t.ty,
                  (Z + t.kz - 1) / t.kz);
  avg_update_kernel<C, kWall><<<grid, dim3(t.tx, t.ty), 0, stream>>>(
      static_cast<const typename C::T*>(fi), flags, dyn, inv_n, mean_u, m2_u,
      mean_rho, Z, Y, X, wall_cd, wall_cd_sides);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch(const void* fi, const uint8_t* flags, const float* dyn,
                   float inv_n, float* mean_u, float* m2_u, float* mean_rho,
                   int Z, int Y, int X, int wall, float wall_cd,
                   float wall_cd_sides, cudaStream_t stream) {
  switch (wall) {
    case 0: return launch_wall<C, 0>(fi, flags, dyn, inv_n, mean_u, m2_u,
                                     mean_rho, Z, Y, X, wall_cd,
                                     wall_cd_sides, stream);
    case 1: return launch_wall<C, 1>(fi, flags, dyn, inv_n, mean_u, m2_u,
                                     mean_rho, Z, Y, X, wall_cd,
                                     wall_cd_sides, stream);
    case 2: return launch_wall<C, 2>(fi, flags, dyn, inv_n, mean_u, m2_u,
                                     mean_rho, Z, Y, X, wall_cd,
                                     wall_cd_sides, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// storage: 0 = f32, 1 = bf16, 2 = f16 (FP16S), 3 = fp16c.  wall: 0 none, 1
// wall_model (Schumann stress at wall_cd), 2 wall_sides too (side stress at
// wall_cd_sides).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int luw_avg_update(const void* fi, const void* flags,
                              const void* dyn, float inv_n, void* mean_u,
                              void* m2_u, void* mean_rho, int Z, int Y, int X,
                              int storage, int wall, float wall_cd,
                              float wall_cd_sides, void* stream) {
  const auto* fl = static_cast<const uint8_t*>(flags);
  const auto* dy = static_cast<const float*>(dyn);
  auto* mu = static_cast<float*>(mean_u);
  auto* m2 = static_cast<float*>(m2_u);
  auto* mr = static_cast<float*>(mean_rho);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define LUW_AVG_ARGS \
  fi, fl, dy, inv_n, mu, m2, mr, Z, Y, X, wall, wall_cd, wall_cd_sides, st
  switch (storage) {
    case 0: err = launch<luw::CodecF32>(LUW_AVG_ARGS); break;
    case 1: err = launch<luw::CodecBF16>(LUW_AVG_ARGS); break;
    case 2: err = launch<luw::CodecF16>(LUW_AVG_ARGS); break;
    case 3: err = launch<luw::CodecFP16C>(LUW_AVG_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef LUW_AVG_ARGS
  return (int)err;
}
