// The tiled body of the fused D3Q19 stream-collide step (K-SC) for Hopper
// (sm_90a): every instance of the step.  stream_collide.cu instantiates it
// for the configurations without a wall model under SRT, stream_collide_wall.cu
// for the wall models and TRT, stream_collide_thermal.cu for D3Q7, and
// stream_collide_halo.cu with stream_collide_halo_thermal.cu for the halo
// mode (K8) of a domain split over devices.  The same march over a block's
// planes with the flag ring (tiled_march) carries the averaging pass (K-AVG,
// avg_update.cu), with shapes of its own.
//
// Replaces: latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step,
// every branch: SRT + LES, force, nudging, sponge (:674-730, :882-889), the
// codecs (:283-373), the wall models' mirrors and stress (:618-650,
// :678-703), TRT (:890-902), the D3Q7 sub-lattice (:732-807, outputs
// :909-913) and the halo mode (:409, :1032-1042, :1222-1241).  The per-cell
// arithmetic after the pull is collide_cell of stream_collide.cuh, so every
// instance evaluates in the Pallas order.
//
// Bound on the H100: device memory.  A cell update reads 19 DDFs and writes
// 19, plus its flag byte: 77 B in the 2-byte storages (153 B f32); thermal
// adds 2 * 7 values, 105 B (209 B); nudging 5 B.  ~600-660 flops per cell
// are far below the compute roof at that traffic.  A pull reads every DDF
// element once (it is a permutation), so what a kernel loses to the bound
// is instructions and latency, measured (cuobjdump, the bf16 instance with
// nudge and sponge; PERF.md): a fluid cell runs ~1,200 SASS instructions
// (the flag mask and ring ~300, the pull ~250, collide_cell with the
// stores ~650, ~390 of them f32), which at the card's issue rate would take
// ~0.86 ms at 424 x 424 x 118; the step takes ~1.37 ms, so latency (the
// f32 chains of collide_cell, one DRAM round trip per plane) holds the
// rest.  This body's design:
//
//   * Index arithmetic.  A 2-D block of TX x TY threads covers a tile of a
//     plane and marches over KZ planes: coordinates come from the block and
//     thread indices, every source is the cell's 32-bit offset plus one of
//     six wrapped neighbour offsets, and only the channel stride d * N is
//     64-bit (19 N exceeds 2^31; Z Y X < 2^31 is checked at launch).  No
//     64-bit division.
//   * Loads that wait for loads.  A block keeps the flags of the planes
//     around its tile with a one-cell rim, (TY + 2) x (TX + 2) bytes each, in
//     a ring in shared memory; every flag the cell's logic reads lies in its
//     3x3x3 neighbourhood (the 18 sources, the mirrors' partners, the
//     stress's five neighbours), so a cell first folds it into a 27-bit mask
//     of solid cells and its own flag byte, then picks all 18 f elements (and
//     its 7 g elements) from the mask and issues every load before any
//     arithmetic.  The ring's planes are fetched ahead by cp.async: the
//     4-byte-aligned words of each rim row (each ring row shifted so that its
//     words land aligned), the unaligned head and tail bytes and the two
//     wrapped edge columns by plain loads that a thread issues before its
//     cell's work and stores after it.
//   * The thermal second memory phase.  The g loads go out with the f loads
//     (thermal_pull_index); the relax (thermal_finish) runs after the
//     forces, where the Pallas kernel evaluates it.
//   * DRAM latency.  Every warp waits one DRAM round trip per plane for
//     its pulls and has nothing in flight while it computes.  Staging the
//     19 pulled windows of the next planes in shared memory by cp.async was
//     12-87% slower on the H100 than this body unstaged, and one bulk copy
//     per row no faster (PERF.md): the step is not held back by bytes in
//     flight, so the body does not stage.  The wall-model and TRT family
//     asks L2 for the next plane's sources (prefetch.global.L2) instead,
//     which helps it and no other family.
//   * The paired instance (stream_collide_tiled_kernel_pair, below): the
//     plain family in bf16 and f16 with X even, two cells per thread along
//     x, every DDF access one 4-byte word, so that the pull's and the
//     stores' instructions and addresses are paid once per pair; each cell
//     still runs collide_cell, so it stores the single-cell instance's
//     codes.
//   * The halo mode (kHalo).  The planes -1 and Z of a slab are the
//     neighbours' (HaloArgs): the ring fetches their flags there, the pulls
//     read their channels there through an element accessor (which the
//     wall models' mirror choice and the D3Q7 pull take too), and the z
//     offsets do not wrap.
//
// The wrap is periodic on all three axes, applied when the ring is filled
// (rows and edge columns) and by the neighbour offsets; the ragged edges of
// x, y and z are masked.  Registers: __launch_bounds__ with the family's
// min_blocks blocks per SM (tile_shape).  Measured times, the sweep and the
// registers are in PERF.md.

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "codec.cuh"
#include "lattice.cuh"
#include "stream_collide.cuh"
#include "thermal.cuh"

namespace luw {

// The tiled body's compile-time shape per family (the thermal instances in
// the 2-byte storages, the thermal ones in f32, the wall-model and TRT ones,
// and the plain ones: no wall model, SRT, not thermal): a block of tx x ty
// threads along (x, y) marching over kz planes, at least min_blocks blocks
// resident per SM (__launch_bounds__, which caps the registers) and how many
// planes ahead each thread asks L2 for its cell's sources (0: none).  Chosen
// per family on the card (chip_sweep.py, chip_smoke.py's 256^3 rows;
// PERF.md): the 2-byte thermal
// instances as 256 x 1 x 8 with 2 blocks (128 registers); in f32, where that
// shape cost +35% at 256^3, as 64 x 2 x 8 with 4 blocks (128 registers); the
// wall-model and TRT ones as 64 x 2 x 8 with 5 blocks (96 registers; 6
// would spill) and one plane prefetched; the plain ones in bf16 and f16 as
// 128 x 1 x 8 with 6 blocks (75-80 registers, no spills; 64 x 2 x 8 with 5
// blocks was 1-4% slower; these run where X is odd and in halo mode, the
// paired instance below everywhere else), and in f32 and fp16c, where that
// shape cost 9% and 21% more than the old body, as 64 x 2 x 8 with 6
// blocks (76-80 registers; 5 blocks was 5% slower in fp16c); none with a
// prefetch (+8-11%).  A build may set a family's five numbers,
// `tx, ty, kz, min_blocks, prefetch`, as LUW_TILE_THERMAL,
// LUW_TILE_THERMAL_F32, LUW_TILE_OTHER, LUW_TILE_PLAIN,
// LUW_TILE_PLAIN_F32_FP16C or LUW_TILE_PLAIN_PAIR in a header it
// pre-includes; that is how the sweep builds its variants (nvcc's -D would
// split the list at its commas).
struct TileShape {
  int tx, ty, kz, min_blocks, prefetch;
};
#ifndef LUW_TILE_THERMAL
#define LUW_TILE_THERMAL 256, 1, 8, 2, 0
#endif
#ifndef LUW_TILE_THERMAL_F32
#define LUW_TILE_THERMAL_F32 64, 2, 8, 4, 0
#endif
#ifndef LUW_TILE_OTHER
#define LUW_TILE_OTHER 64, 2, 8, 5, 1
#endif
#ifndef LUW_TILE_PLAIN
#define LUW_TILE_PLAIN 128, 1, 8, 6, 0
#endif
#ifndef LUW_TILE_PLAIN_F32_FP16C
#define LUW_TILE_PLAIN_F32_FP16C 64, 2, 8, 6, 0
#endif
// The averaging pass (K-AVG, avg_update.cu) marches the same way with
// shapes of its own, chosen on the card (chip_sweep.py --family avg;
// PERF.md): without a wall model 128 x 1 x 16 with 7 blocks (72
// registers; 128 x 1 x 8 was 1.5-2.5% slower, 8 blocks spill), with one
// 64 x 2 x 8 with 7 blocks (9% faster there than 128 x 1 x 8, 7% than
// 128 x 1 x 16), set as LUW_TILE_AVG and LUW_TILE_AVG_WALL.
#ifndef LUW_TILE_AVG
#define LUW_TILE_AVG 128, 1, 16, 7, 0
#endif
#ifndef LUW_TILE_AVG_WALL
#define LUW_TILE_AVG_WALL 64, 2, 8, 7, 0
#endif
// f32: the storage takes 4 bytes per value; plain: no wall model, SRT;
// fp16c: the storage is the software-decoded 1-4-11 float.
__host__ __device__ constexpr TileShape tile_shape(bool thermal, bool f32,
                                                  bool plain = false,
                                                  bool fp16c = false) {
  return plain && (f32 || fp16c) ? TileShape{LUW_TILE_PLAIN_F32_FP16C}
         : plain                 ? TileShape{LUW_TILE_PLAIN}
         : !thermal              ? TileShape{LUW_TILE_OTHER}
         : f32                   ? TileShape{LUW_TILE_THERMAL_F32}
                                 : TileShape{LUW_TILE_THERMAL};
}
// The bytes of a flag ring plane: ty + 2 rows of tx + 8 (the rim, and the
// shift that aligns each row's words); the ring holds 3 planes, each with
// its row shifts, in static shared memory.
__host__ __device__ constexpr int ring_plane_bytes(TileShape t) {
  return (t.ty + 2) * (t.tx + 8);
}
__host__ __device__ constexpr int ring_bytes(TileShape t) {
  return 3 * (ring_plane_bytes(t) + t.ty + 2);
}
// The H100's shared memory: 48 KB of static shared memory a block can take,
// 228 KB an SM holds, of which 1 KB per resident block is the system's.
constexpr int kSmemStatic = 49152;
constexpr int kSmemPerSm = 233472;
constexpr int kSmemReserved = 1024;
// A shape the ring takes: tx a multiple of 4 (the flag rows' words), one
// thread per word of a flag rim row's copy and 8 threads per flag rim row's
// plain bytes, and min_blocks blocks' rings on one SM.
__host__ __device__ constexpr bool tile_ok(TileShape t) {
  return t.tx >= 4 && t.tx % 4 == 0 && t.ty >= 1 && t.kz >= 1 &&
         t.min_blocks >= 1 && t.prefetch >= 0 &&
         (t.ty + 2) * (t.tx / 4) <= t.tx * t.ty &&
         (t.ty + 2) * 8 <= t.tx * t.ty && ring_bytes(t) <= kSmemStatic &&
         t.min_blocks * (ring_bytes(t) + kSmemReserved) <= kSmemPerSm;
}
static_assert(tile_ok(tile_shape(true, false)) &&
                  tile_ok(tile_shape(true, true)) &&
                  tile_ok(tile_shape(false, false)) &&
                  tile_ok(tile_shape(false, false, true)) &&
                  tile_ok(tile_shape(false, true, true)) &&
                  tile_ok(TileShape{LUW_TILE_AVG}) &&
                  tile_ok(TileShape{LUW_TILE_AVG_WALL}),
              "a tiled body shape the ring does not take");
// The neighbourhood mask takes each flag's kTypeS bit by masking and shifting.
static_assert(kTypeS == 1, "the neighbourhood mask needs kTypeS in bit 0");

// The bit of the neighbourhood mask for the cell (dz, dy, dx) away.
__device__ __forceinline__ constexpr int nb_bit(int dz, int dy, int dx) {
  return (dz + 1) * 9 + (dy + 1) * 3 + dx + 1;
}

// Issue the fetch of flag plane zz into a ring plane and its row shifts.  Row
// r holds the flags of y0 - 1 + r (wrapped) at columns c = 0 .. txn + 1 for
// x0 - 1 + c (wrapped), byte c at r * (TX + 8) + shift[r] + c, with shift[r]
// chosen so that the row's aligned words land on aligned shared addresses.
// This thread copies at most one word by cp.async (committed by the caller)
// and loads at most one plain byte, which it returns in v with its position
// (-1: none) for the caller to store once the copy is due.
__device__ __forceinline__ int ring_fetch(
    uint8_t* ring, uint8_t* shift, const uint8_t* __restrict__ flags, int zz,
    int tid, int x0, int y0, int txn, int tyn, int TX, int X, int Y,
    uint8_t& v) {
  const int R = TX + 8;
  const int rows = tyn + 2;
  {
    const int wpr = TX >> 2;  // words a row can hold
    const int r = tid / wpr, w = tid - r * wpr;
    if (r < rows) {
      const uint8_t* pa = flags + (zz * Y + wrap(y0 - 1 + r, Y)) * X + x0;
      const int mis = (int)((uintptr_t)pa & 3);
      const int head = min((4 - mis) & 3, txn);
      if (w < ((txn - head) >> 2)) {
        const int sh = (mis + 3) & 3;
        __pipeline_memcpy_async(ring + r * R + sh + 1 + head + 4 * w,
                                pa + head + 4 * w, 4);
      }
    }
  }
  const int r = tid >> 3, k = tid & 7;
  if (r >= rows) return -1;
  const int row = (zz * Y + wrap(y0 - 1 + r, Y)) * X;
  const int mis = (int)((uintptr_t)(flags + row + x0) & 3);
  const int sh = (mis + 3) & 3;
  const int head = min((4 - mis) & 3, txn);
  const int nw = (txn - head) >> 2;
  int col, xx;
  if (k == 0) {  // the left edge column, wrapped
    shift[r] = (uint8_t)sh;
    col = 0;
    xx = wrap(x0 - 1, X);
  } else if (k == 1) {  // the right edge column, wrapped
    col = txn + 1;
    xx = wrap(x0 + txn, X);
  } else if (k < 5) {  // the unaligned head
    if (k - 2 >= head) return -1;
    col = k - 1;
    xx = x0 + col - 1;
  } else {  // the tail after the words
    col = 1 + head + 4 * nw + (k - 5);
    if (col > txn) return -1;
    xx = x0 + col - 1;
  }
  v = flags[row + xx];
  return r * R + sh + col;
}

// Ask the L2 cache for the line holding p (no register waits for it).
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// Prefetch into L2 what the cell (z, y, x) = n will pull: the source of
// every f direction, whatever the flags choose.
template <class C>
__device__ __forceinline__ void prefetch_cell(
    const typename C::T* __restrict__ fa, int n, long long N, int ozm,
    int ozp, int oym, int oyp, int oxm, int oxp) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
#pragma unroll
  for (int d = 0; d < 19; ++d)
    prefetch_l2(fa + (d * N + (n + (CZ[d] > 0 ? ozm : CZ[d] < 0 ? ozp : 0) +
                               (CY[d] > 0 ? oym : CY[d] < 0 ? oyp : 0) +
                               (CX[d] > 0 ? oxm : CX[d] < 0 ? oxp : 0))));
}

// One cell of the tiled body: fl its flags, nb the solid bits of its 3x3x3
// neighbourhood (nb_bit), n its offset in a channel, the o* the offsets of
// its neighbours along each axis (wrapped; in a halo-mode slab the z ones
// do not wrap, and a pull beyond the slab reads the halo planes `ha`).
template <class C, bool kForce, int kNudge, int kSponge, int kWall, bool kTrt,
          bool kThermal, bool kHalo = false>
__device__ __forceinline__ void tiled_cell(
    const typename C::T* __restrict__ fa, typename C::T* __restrict__ fb,
    uint8_t fl, uint32_t nb, int n, long long N, int z, int y, int x, int Y,
    int X, int ozm, int ozp, int oym, int oyp, int oxm, int oxp,
    const float* __restrict__ dyn, const float* __restrict__ nudge_sigma,
    const uint8_t* __restrict__ nudge_face, const float* __restrict__ uw,
    const float* __restrict__ ue, const float* __restrict__ us,
    const float* __restrict__ un, const float* __restrict__ ut,
    const float* __restrict__ ub, const float* __restrict__ sponge_z,
    int nudge_vertical, int subgrid, float omega, float tau0, float tau0_sq,
    float wall_cd, float wall_cd_sides, const ThermArgs& th,
    const HaloArgs& ha, int Z) {
  using T = typename C::T;
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  const int CX7[7] = {0, 1, -1, 0, 0, 0, 0};
  const int CY7[7] = {0, 0, 0, 1, -1, 0, 0};
  const int CZ7[7] = {0, 0, 0, 0, 0, 1, -1};
  // the offset from the cell to the cell (dz, dy, dx) away, and whether
  // that one is solid
  auto off = [&](int dz, int dy, int dx) {
    return (dz < 0 ? ozm : dz > 0 ? ozp : 0) + (dy < 0 ? oym : dy > 0 ? oyp : 0) +
           (dx < 0 ? oxm : dx > 0 ? oxp : 0);
  };
  auto solid = [&](int dz, int dy, int dx) -> bool {
    return (nb >> nb_bit(dz, dy, dx)) & 1u;
  };
  const T* __restrict__ ga = static_cast<const T*>(th.ga);
  T* __restrict__ gb = static_cast<T*>(th.gb);
  // a halo-mode slab's element: channel ch of the cell at offset p, in the
  // plane dz from the cell's -- the halo plane below (channels 9-13 of fp)
  // or above (14-18 of fm) where that plane leaves the slab, else fa's (the
  // thermal g: gp / gm, one channel each, else ga's)
  struct Elem {
    const T* p;
    long long i;
  };
  const int plane = Y * X;
  auto at_halo = [&](int ch, int p, int dz) -> Elem {
    if (dz < 0 && z == 0)
      return {static_cast<const T*>(ha.fp), (ch - 9) * ha.fps + (p + plane)};
    if (dz > 0 && z == Z - 1)
      return {static_cast<const T*>(ha.fm), (ch - 14) * ha.fms + (p - Z * plane)};
    return {fa, ch * N + p};
  };
  auto at_halo_g = [&](int ch, int p, int dz) -> Elem {
    if (dz < 0 && z == 0) return {static_cast<const T*>(ha.gp), p + plane};
    if (dz > 0 && z == Z - 1)
      return {static_cast<const T*>(ha.gm), (long long)(p - Z * plane)};
    return {ga, ch * N + p};
  };
  auto at = [&](int ch, int p, int) { return ch * N + p; };

  if (fl & kTypeS) {
#pragma unroll
    for (int d = 0; d < 19; ++d) fb[d * N + n] = C::enc(0.0f);
    if (kThermal) thermal_zero<C>(gb, n, N);
    return;
  }
  T graw[7];
  if (kThermal) {
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      const bool src_solid = solid(-CZ7[d], -CY7[d], -CX7[d]);
      const int src_off = off(-CZ7[d], -CY7[d], -CX7[d]);
      if constexpr (kHalo) {
        const Elem e =
            thermal_pull_index(d, fl, src_solid, n, src_off, at_halo_g);
        graw[d] = e.p[e.i];
      } else {
        graw[d] = ga[thermal_pull_index(d, fl, src_solid, n, src_off, at)];
      }
    }
  }
  if (kThermal && (fl & kTypeE)) {
    // frozen f; g collides with the velocity of the cell's own stored
    // equilibria; no sponge on T here
    float rho = 0.0f, mx = 0.0f, my = 0.0f, mz = 0.0f;
#pragma unroll
    for (int d = 0; d < 19; ++d) {
      const T v = fa[d * N + n];
      fb[d * N + n] = v;
      const float q = C::dec(v);
      rho = d == 0 ? q : rho + q;
      if (CX[d] == 1) mx += q; else if (CX[d] == -1) mx -= q;
      if (CY[d] == 1) my += q; else if (CY[d] == -1) my -= q;
      if (CZ[d] == 1) mz += q; else if (CZ[d] == -1) mz -= q;
    }
    const float inv = 1.0f / (rho + 1.0f);
    thermal_finish<C>(graw, fl, gb, n, N, y, x, X, mx * inv, my * inv,
                      mz * inv, 0.0f, th.tt, th.omega_t);
    return;
  }
  if (fl & kTypeE) {  // frozen equilibrium: the stored bits go back unchanged
#pragma unroll
    for (int d = 0; d < 19; ++d) fb[d * N + n] = fa[d * N + n];
    return;
  }

  // ---- the pull: every element chosen from the mask, every load issued
  // ---- before any arithmetic
  float f[19];
  if constexpr (kHalo) {
    f[0] = C::load(fa, n);
#pragma unroll
    for (int d = 1; d < 19; ++d) {
      const int src = n + off(-CZ[d], -CY[d], -CX[d]);
      Elem e = at_halo(d, src, -CZ[d]);
      if (solid(-CZ[d], -CY[d], -CX[d])) {
        if (kWall == 0) {
          e = at_halo(OPP[d], n, 0);
        } else {
          e = solid_source_pick<kWall>(
              [&](int, int dz, int dy, int dx) { return solid(dz, dy, dx); },
              at_halo, d, n, src, -off(-CZ[d], 0, 0), -off(0, 0, -CX[d]),
              -off(0, -CY[d], 0));
        }
      }
      f[d] = C::load(e.p, e.i);
    }
  } else {
    f[0] = C::load(fa, n);
#pragma unroll
    for (int d = 1; d < 19; ++d) {
      const int src = n + off(-CZ[d], -CY[d], -CX[d]);
      long long idx = d * N + src;
      if (solid(-CZ[d], -CY[d], -CX[d])) {
        if (kWall == 0) {
          idx = OPP[d] * N + n;
        } else {
          idx = solid_source_pick<kWall>(
              [&](int, int dz, int dy, int dx) { return solid(dz, dy, dx); },
              at, d, n, src, -off(-CZ[d], 0, 0), -off(0, 0, -CX[d]),
              -off(0, -CY[d], 0));
        }
      }
      f[d] = C::load(fa, idx);
    }
  }

  collide_cell<C, kForce, kNudge, kSponge, kTrt, kThermal>(
      f, n, z, y, x, Y, X, dyn, nudge_sigma, nudge_face, uw, ue, us, un, ut,
      ub, sponge_z, nudge_vertical, subgrid, omega, tau0, tau0_sq, th,
      [&](float& Fx, float& Fy, float& Fz, float ux, float uy, float uz,
          float rho) {
        wall_stress_at<kWall>(
            Fx, Fy, Fz, ux, uy, uz, rho,
            [&](int dz, int dy, int dx) -> uint8_t {
              return solid(dz, dy, dx) ? kTypeS : 0;
            },
            wall_cd, wall_cd_sides);
      },
      [&](float ux, float uy, float uz) {
        return thermal_finish<C>(graw, fl, gb, n, N, y, x, X, ux, uy, uz,
                                 sponge_z != nullptr ? sponge_z[z] : 0.0f,
                                 th.tt, th.omega_t);
      },
      [&](int d, float v) { fb[d * N + n] = C::enc(v); });
}

// The shape of a codec's family: thermal, or plain (no wall model, SRT),
// or the wall-model and TRT one.
template <class C>
__host__ __device__ constexpr TileShape tile_shape_of(bool thermal,
                                                      bool plain) {
  return tile_shape(thermal, sizeof(typename C::T) == 4, plain,
                    std::is_same<C, CodecFP16C>::value);
}

// The flags of plane zz in [-1, Z] of a slab: the halo's planes beyond it
// (kHalo), else plane wrap(zz, Z) of flags; as a base and a plane index for
// ring_fetch.
template <bool kHalo>
__device__ __forceinline__ const uint8_t* flag_plane(
    const uint8_t* __restrict__ flags, const HaloArgs& ha, int zz, int Z,
    int& zi) {
  if (kHalo && (zz < 0 || zz >= Z)) {
    zi = 0;
    return zz < 0 ? ha.flb : ha.fla;
  }
  zi = wrap(zz, Z);
  return flags;
}

// A block's march over its planes z0 .. z1 - 1, for K-AVG (avg_update.cu):
// its TX x TY threads cover the tile at (blockIdx.x TX, blockIdx.y TY) of
// each plane in turn, with the flags of the planes z - 1, z, z + 1
// (wrapped) in a ring in shared memory, fetched a plane ahead.  For each
// plane z every thread
// calls cell(z, live, fl, nb): live whether its cell lies inside the
// grid's ragged edge, fl the cell's flags and nb the solid bits of its
// 3x3x3 neighbourhood (nb_bit; both 0 where not live).  The fetch of the
// ring's next plane is in flight during the call.  The step kernel below
// runs the same march written out in its own body: taking it through this
// helper changed 9 of its 112 instances by up to 8 SASS instructions or 3
// registers (chip_compare.py, PERF.md).
template <int TX, int TY, class Cell>
__device__ __forceinline__ void tiled_march(const uint8_t* __restrict__ flags,
                                            int z0, int z1, int Z, int Y,
                                            int X, const Cell& cell) {
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int txn = min(TX, X - x0), tyn = min(TY, Y - y0);
  const int R = TX + 8;
  const bool live = tx < txn && ty < tyn;

  __shared__ __align__(16) uint8_t ring[3][ring_plane_bytes(TileShape{TX, TY, 1, 1, 0})];
  __shared__ uint8_t shift[3][TY + 2];

  // the ring's first three planes: z0 - 1, z0, z0 + 1 (wrapped)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uint8_t v;
    const int pos = ring_fetch(ring[j], shift[j], flags, wrap(z0 - 1 + j, Z),
                               tid, x0, y0, txn, tyn, TX, X, Y, v);
    if (pos >= 0) ring[j][pos] = v;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  int sm = 0, s0 = 1, sp = 2;  // ring planes of z - 1, z, z + 1
  for (int z = z0; z < z1; ++z) {
    uint8_t fl = 0;
    uint32_t nb = 0;
    if (live) {
      const int sl[3] = {sm, s0, sp};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int row = ty + b;
          const uint8_t* p = ring[sl[a]] + row * R + shift[sl[a]][row] + tx;
          const int bit = a * 9 + b * 3;
          nb |= ((uint32_t)(p[0] & kTypeS) << bit) |
                ((uint32_t)(p[1] & kTypeS) << (bit + 1)) |
                ((uint32_t)(p[2] & kTypeS) << (bit + 2));
          if (a == 1 && b == 1) fl = p[1];
        }
      }
    }
    __syncthreads();  // the plane of z - 1 is free: fetch z + 2 into it
    const bool more = z + 1 < z1;
    int pos = -1;
    uint8_t v = 0;
    if (more) {
      pos = ring_fetch(ring[sm], shift[sm], flags, wrap(z + 2, Z), tid, x0,
                       y0, txn, tyn, TX, X, Y, v);
      __pipeline_commit();
    }
    cell(z, live, fl, nb);
    if (more) {
      if (pos >= 0) ring[sm][pos] = v;
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int t = sm;
    sm = s0;
    s0 = sp;
    sp = t;
  }
}

// kNudge / kSponge: 0 off, 1 on, 2 on where the pointer is not null (every
// instance with the volume force takes 2, which keeps their count down and
// cost nothing measurable in the plain family: chip_sweep.py, PERF.md).
// Block (TX, TY) and KZ planes per block from tile_shape_of, grid (x tiles,
// y tiles, z chunks of KZ planes).
template <class C, bool kForce, int kNudge, int kSponge, int kWall, bool kTrt,
          bool kThermal, bool kHalo = false>
__global__ void __launch_bounds__(
    tile_shape_of<C>(kThermal, kWall == 0 && !kTrt && !kThermal).tx *
        tile_shape_of<C>(kThermal, kWall == 0 && !kTrt && !kThermal).ty,
    tile_shape_of<C>(kThermal, kWall == 0 && !kTrt && !kThermal).min_blocks)
stream_collide_tiled_kernel(
    const typename C::T* __restrict__ fa, typename C::T* __restrict__ fb,
    const uint8_t* __restrict__ flags, const float* __restrict__ dyn,
    const float* __restrict__ nudge_sigma,
    const uint8_t* __restrict__ nudge_face, const float* __restrict__ uw,
    const float* __restrict__ ue, const float* __restrict__ us,
    const float* __restrict__ un, const float* __restrict__ ut,
    const float* __restrict__ ub, const float* __restrict__ sponge_z, int Z,
    int Y, int X, int nudge_vertical, int subgrid, float omega, float tau0,
    float tau0_sq, float wall_cd, float wall_cd_sides, ThermArgs th,
    HaloArgs ha) {
  constexpr TileShape kShape =
      tile_shape_of<C>(kThermal, kWall == 0 && !kTrt && !kThermal);
  constexpr int TX = kShape.tx, TY = kShape.ty, KZ = kShape.kz;

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * KZ, z1 = min(z0 + KZ, Z);
  const int txn = min(TX, X - x0), tyn = min(TY, Y - y0);
  const int R = TX + 8;
  const bool live = tx < txn && ty < tyn;
  const int x = x0 + tx, y = y0 + ty;
  const int plane = Y * X;
  const long long N = (long long)Z * plane;
  const int oxm = x == 0 ? X - 1 : -1, oxp = x == X - 1 ? 1 - X : 1;
  const int oym = y == 0 ? (Y - 1) * X : -X, oyp = y == Y - 1 ? (1 - Y) * X : X;
  // the z offsets of plane z: wrapped, or in a halo-mode slab straight into
  // the halo planes (which the accessors then read)
  auto ozm_of = [&](int z) { return !kHalo && z == 0 ? (Z - 1) * plane : -plane; };
  auto ozp_of = [&](int z) {
    return !kHalo && z == Z - 1 ? (1 - Z) * plane : plane;
  };

  __shared__ __align__(16) uint8_t ring[3][ring_plane_bytes(kShape)];
  __shared__ uint8_t shift[3][TY + 2];

  // the ring's first three planes: z0 - 1, z0, z0 + 1 (wrapped)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uint8_t v;
    int zi;
    const uint8_t* fp = flag_plane<kHalo>(flags, ha, z0 - 1 + j, Z, zi);
    const int pos = ring_fetch(ring[j], shift[j], fp, zi, tid, x0, y0, txn,
                               tyn, TX, X, Y, v);
    if (pos >= 0) ring[j][pos] = v;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  int sm = 0, s0 = 1, sp = 2;  // ring planes of z - 1, z, z + 1
  for (int z = z0; z < z1; ++z) {
    uint8_t fl = 0;
    uint32_t nb = 0;
    if (live) {
      const int sl[3] = {sm, s0, sp};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int row = ty + b;
          const uint8_t* p = ring[sl[a]] + row * R + shift[sl[a]][row] + tx;
          const int bit = a * 9 + b * 3;
          nb |= ((uint32_t)(p[0] & kTypeS) << bit) |
                ((uint32_t)(p[1] & kTypeS) << (bit + 1)) |
                ((uint32_t)(p[2] & kTypeS) << (bit + 2));
          if (a == 1 && b == 1) fl = p[1];
        }
      }
    }
    __syncthreads();  // the plane of z - 1 is free: fetch z + 2 into it
    const bool more = z + 1 < z1;
    int pos = -1;
    uint8_t v = 0;
    if (more) {
      int zi;
      const uint8_t* fp = flag_plane<kHalo>(flags, ha, z + 2, Z, zi);
      pos = ring_fetch(ring[sm], shift[sm], fp, zi, tid, x0, y0, txn, tyn,
                       TX, X, Y, v);
      __pipeline_commit();
    }
    constexpr int kAhead = kShape.prefetch;
    if (live && kAhead > 0 && z + kAhead < z1) {
      const int zq = z + kAhead;
      prefetch_cell<C>(fa, (zq * Y + y) * X + x, N,
                       zq == 0 ? (Z - 1) * plane : -plane,
                       zq == Z - 1 ? (1 - Z) * plane : plane, oym, oyp, oxm,
                       oxp);
    }
    if (live) {
      tiled_cell<C, kForce, kNudge, kSponge, kWall, kTrt, kThermal, kHalo>(
          fa, fb, fl, nb, (z * Y + y) * X + x, N, z, y, x, Y, X, ozm_of(z),
          ozp_of(z), oym, oyp, oxm, oxp, dyn, nudge_sigma, nudge_face, uw,
          ue, us, un, ut, ub, sponge_z, nudge_vertical, subgrid, omega, tau0,
          tau0_sq, wall_cd, wall_cd_sides, th, ha, Z);
    }
    if (more) {
      if (pos >= 0) ring[sm][pos] = v;
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int t = sm;
    sm = s0;
    s0 = sp;
    sp = t;
  }
}

template <class C, bool kForce, int kNudge, int kSponge, int kWall, bool kTrt,
          bool kThermal, bool kHalo = false>
cudaError_t sc_launch_tiled(const ScArgs& a, cudaStream_t stream) {
  using T = typename C::T;
  constexpr TileShape t =
      tile_shape_of<C>(kThermal, kWall == 0 && !kTrt && !kThermal);
  // every cell offset, and in a halo-mode slab those of the halo planes
  // around it, is a 32-bit int
  if ((long long)(a.Z + (kHalo ? 2 : 0)) * a.Y * a.X > INT_MAX)
    return cudaErrorInvalidValue;
  const dim3 grid((a.X + t.tx - 1) / t.tx, (a.Y + t.ty - 1) / t.ty,
                  (a.Z + t.kz - 1) / t.kz);
  auto kernel = stream_collide_tiled_kernel<C, kForce, kNudge, kSponge, kWall,
                                            kTrt, kThermal, kHalo>;
  kernel<<<grid, dim3(t.tx, t.ty), 0, stream>>>(
      static_cast<const T*>(a.fa), static_cast<T*>(a.fb), a.flags, a.dyn,
      a.nudge_sigma, a.nudge_face, a.uw, a.ue, a.us, a.un, a.ut, a.ub,
      a.sponge_z, a.Z, a.Y, a.X, a.nudge_vertical, a.subgrid, a.omega,
      a.tau0, a.tau0_sq, a.wall_cd, a.wall_cd_sides, a.th, a.halo);
  return cudaGetLastError();
}

// ---- The paired instance of the plain family --------------------------------
//
// The plain family (no wall model, SRT, not thermal, not halo mode) in the
// 2-byte storages the card converts in hardware, bf16 and f16, on a grid whose
// X is even: each thread owns the two neighbouring cells (x, x + 1), x even,
// so every element pair it pulls or stores is one aligned 4-byte word (the
// channel offset d N + n of an even x is even).  Per pair of cells: one
// load per direction (the 9 with cx = 0 bring both sources; for the 10 with
// cx = +-1 the pair's sources straddle a word, so each lane loads its own
// word of that row and takes the neighbour lane's by a shuffle, and only a
// warp's edge lanes and the x-wrap load the word beside theirs), a
// bounce-back word (the cell's own f_opp) only where either cell's source is
// solid, the own words of all 19 channels only where either cell is TYPE_E,
// one 4-byte store per direction, nudge_sigma as one float2 and nudge_face
// as one 2-byte load; the flag mask of both cells from the same ring words.
// Each cell then runs collide_cell as the single-cell instances do, one
// after the other, and the two encoded results of a direction are packed
// into the word stored, so every code equals the single-cell instance's.

// The paired instance's shape: tx threads along x (a multiple of 32, so a
// warp lies in one row), each with two cells, ty along y, kz planes per
// block, min_blocks per SM; no L2 prefetch.  LUW_TILE_PLAIN_PAIR sets it as
// the other families' shapes are set.  Chosen on the card (chip_sweep.py
// --family pair; PERF.md): 32 x 8 x 8 with 2 blocks (128 registers, no
// spill in bf16); 5 blocks spill, 3 (168 registers) were 10% slower.
#ifndef LUW_TILE_PLAIN_PAIR
#define LUW_TILE_PLAIN_PAIR 32, 8, 8, 2, 0
#endif
__host__ __device__ constexpr TileShape pair_shape() {
  return TileShape{LUW_TILE_PLAIN_PAIR};
}
// The tile of cells it covers, whose flag ring (2 tx + 2 columns) it keeps.
__host__ __device__ constexpr TileShape pair_cells(TileShape t) {
  return TileShape{2 * t.tx, t.ty, t.kz, t.min_blocks, t.prefetch};
}
// A paired shape the ring takes: a thread per word of a rim row of the
// cell tile and 8 per rim row (ring_fetch), and tile_ok's shared memory.
__host__ __device__ constexpr bool pair_tile_ok(TileShape t) {
  return t.tx >= 32 && t.tx % 32 == 0 && t.ty >= 1 && t.kz >= 1 &&
         t.min_blocks >= 1 && t.prefetch == 0 && t.tx * t.ty <= 1024 &&
         (t.ty + 2) * (t.tx / 2) <= t.tx * t.ty &&
         (t.ty + 2) * 8 <= t.tx * t.ty &&
         ring_bytes(pair_cells(t)) <= kSmemStatic &&
         t.min_blocks * (ring_bytes(pair_cells(t)) + kSmemReserved) <=
             kSmemPerSm;
}
static_assert(pair_tile_ok(pair_shape()),
              "a paired shape the ring does not take");

// p as the compiler must keep it: the offsets added to it later are not
// folded into the one that made it, so that each word's address is one
// register pair plus a channel's offset.
template <class T>
__device__ __forceinline__ T* pinned(T* p) {
#ifdef __CUDA_ARCH__
  asm("" : "+l"(p));
#endif
  return p;
}

// v, which the compiler must take as computed where this is called (not
// hoisted out of a loop).
__device__ __forceinline__ int remade(int v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(v));
#endif
  return v;
}

// The bits of the neighbourhood mask (nb_bit) that some direction's pull
// source takes: the 6 face and 12 edge neighbours, not the centre or the
// corners.
__host__ __device__ constexpr uint32_t source_bits() {
  uint32_t m = 0;
  for (int dz = -1; dz <= 1; ++dz)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const int k = (dz != 0) + (dy != 0) + (dx != 0);
        if (k == 1 || k == 2) m |= 1u << ((dz + 1) * 9 + (dy + 1) * 3 + dx + 1);
      }
  return m;
}
static_assert(source_bits() == 0x02EBDEBAu, "D3Q19 has 18 pull sources");

// The codecs the paired instance takes: 2-byte, converted in hardware.
template <class C>
constexpr bool kPairCodec = std::is_same<C, CodecBF16>::value ||
                            std::is_same<C, CodecF16>::value;

// kNudge 1: the nudging band is on (its two inputs are read per pair and
// handed to collide_cell from registers), 0: off; kSponge as the tiled body's.
template <class C, bool kForce, int kNudge, int kSponge>
__global__ void __launch_bounds__(pair_shape().tx * pair_shape().ty,
                                  pair_shape().min_blocks)
stream_collide_tiled_kernel_pair(
    const uint32_t* __restrict__ fa, uint32_t* __restrict__ fb,
    const uint8_t* __restrict__ flags, const float* __restrict__ dyn,
    const float* __restrict__ nudge_sigma,
    const uint8_t* __restrict__ nudge_face, const float* __restrict__ uw,
    const float* __restrict__ ue, const float* __restrict__ us,
    const float* __restrict__ un, const float* __restrict__ ut,
    const float* __restrict__ ub, const float* __restrict__ sponge_z, int Z,
    int Y, int X, int nudge_vertical, int subgrid, float omega, float tau0,
    float tau0_sq) {
  static_assert(kPairCodec<C> && kNudge >= 0 && kNudge <= 1,
                "the paired instance takes bf16 or f16, nudging 0 or 1");
  constexpr TileShape kShape = pair_shape(), kCells = pair_cells(kShape);
  constexpr int TX = kShape.tx, TY = kShape.ty, KZ = kShape.kz;
  constexpr int CW = kCells.tx;
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};

  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const int lane = tx & 31;
  const int x0 = blockIdx.x * CW, y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * KZ, z1 = min(z0 + KZ, Z);
  const int txn = min(CW, X - x0), tyn = min(TY, Y - y0);
  const int R = CW + 8;
  const bool live = 2 * tx < txn && ty < tyn;
  const int x = x0 + 2 * tx, y = y0 + ty;
  // every lane loads, so that no load waits on a test: a lane beyond the
  // grid's ragged edge reads the last pair of the row or plane (xc, yc)
  // and stores nothing
  const int xc = min(x, X - 2), yc = min(y, Y - 1);
  // offsets in words (element pairs): X, and so every cell offset below, is
  // even
  const int plane = Y * X;
  const long long N2 = (long long)Z * plane / 2;
  const int oym = (yc == 0 ? (Y - 1) * X : -X) / 2;
  const int oyp = (yc == Y - 1 ? (1 - Y) * X : X) / 2;
  // the words beside the pair's own, wrapped, which a warp's first lane (for
  // cx = +1) and its last lane or the last pair of a row (cx = -1) load
  const int oxm = xc == 0 ? X / 2 - 1 : -1, oxp = xc + 2 == X ? 1 - X / 2 : 1;
  const bool left = lane == 0, right = lane == 31 || xc + 2 == X;
  // channel d's offset in bytes, and a word that far past p
  const unsigned long long chan_bytes = 4ull * (unsigned long long)N2;
  auto at = [&](auto* p, int d) {
    using W = std::remove_pointer_t<decltype(p)>;
    return reinterpret_cast<W*>(
        reinterpret_cast<std::conditional_t<std::is_const<W>::value,
                                            const char*, char*>>(p) +
        d * chan_bytes);
  };

  __shared__ __align__(16) uint8_t ring[3][ring_plane_bytes(kCells)];
  __shared__ uint8_t shift[3][TY + 2];

  // the ring's first three planes: z0 - 1, z0, z0 + 1 (wrapped)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uint8_t v;
    const int pos = ring_fetch(ring[j], shift[j], flags, wrap(z0 - 1 + j, Z),
                               tid, x0, y0, txn, tyn, CW, X, Y, v);
    if (pos >= 0) ring[j][pos] = v;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  int sm = 0, s0 = 1, sp = 2;  // ring planes of z - 1, z, z + 1
  for (int z = z0; z < z1; ++z) {
    // both cells' flags and the solid bits of their neighbourhoods (nb_bit),
    // from the four ring columns x - 1 .. x + 2 of each of the nine rows
    uint32_t nba = 0, nbb = 0, fla = 0, flb = 0;
    if (live) {
      const int sl[3] = {sm, s0, sp};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int row = ty + b;
          const int o = row * R + shift[sl[a]][row] + 2 * tx;
          const uint32_t* wp =
              reinterpret_cast<const uint32_t*>(ring[sl[a]]) + (o >> 2);
          const uint32_t w = __funnelshift_r(wp[0], wp[1], (o & 3) * 8);
          // kTypeS of the four columns into bits 0 .. 3
          const uint32_t q = ((w & 0x01010101u) * 0x00204081u) >> 21;
          const int bit = a * 9 + b * 3;
          nba |= (q & 7u) << bit;
          nbb |= ((q >> 1) & 7u) << bit;
          if (a == 1 && b == 1) {
            fla = (w >> 8) & 0xFFu;
            flb = (w >> 16) & 0xFFu;
          }
        }
      }
    }
    __syncthreads();  // the plane of z - 1 is free: fetch z + 2 into it
    const bool more = z + 1 < z1;
    int pos = -1;
    uint8_t v = 0;
    if (more) {
      pos = ring_fetch(ring[sm], shift[sm], flags, wrap(z + 2, Z), tid, x0,
                       y0, txn, tyn, CW, X, Y, v);
      __pipeline_commit();
    }

    // ---- the pull: every word chosen from the masks, every load issued
    // ---- before any arithmetic; the shuffles run on every lane
    const int n = ((z * Y + yc) * X + xc) / 2;  // the pair's word in a channel
    const int ozm = (z == 0 ? (Z - 1) * plane : -plane) / 2;
    const int ozp = (z == Z - 1 ? (1 - Z) * plane : plane) / 2;
    const bool sa = fla & kTypeS, sb = flb & kTypeS;
    const bool ea = !sa && (fla & kTypeE), eb = !sb && (flb & kTypeE);
    const bool ca = live && !sa && !ea, cb = live && !sb && !eb;  // collide
    // the pair's own word of channel 0 and the row of each source, so that
    // every word a lane reads or writes is a row's pointer plus a channel's
    // offset (at)
    const uint32_t* __restrict__ own_row = pinned(fa + n);
    const uint32_t* __restrict__ rows[3][3];  // [dz + 1][dy + 1]
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        rows[a][b] = pinned(own_row + ((a == 0 ? ozm : a == 2 ? ozp : 0) +
                                       (b == 0 ? oym : b == 2 ? oyp : 0)));
    auto row = [&](int d) { return rows[1 - CZ[d]][1 - CY[d]]; };
    uint32_t w[19], side[19];
#pragma unroll
    for (int d = 0; d < 19; ++d) w[d] = __ldg(at(row(d), d));
#pragma unroll
    for (int d = 1; d < 19; ++d) {
      side[d] = 0u;
      if (CX[d] != 0 && (CX[d] > 0 ? left : right))
        side[d] = __ldg(at(row(d) + (CX[d] > 0 ? oxm : oxp), d));
    }
    // the cells whose source in some direction is solid take f_opp of their
    // own there: where any lane of the warp has one, its own words
    constexpr uint32_t kSources = source_bits();
    const uint32_t srca = ca ? nba & kSources : 0u;
    const uint32_t srcb = cb ? nbb & kSources : 0u;
    const bool bounce = __any_sync(0xFFFFFFFFu, (srca | srcb) != 0u);
    uint32_t own[19];
#pragma unroll
    for (int d = 0; d < 19; ++d) own[d] = 0u;
    if (bounce) {
#pragma unroll
      for (int d = 1; d < 19; ++d) {
        const int bit = nb_bit(-CZ[d], -CY[d], -CX[d]);
        if (((srca | srcb) >> bit) & 1u) own[OPP[d]] = __ldg(at(own_row, OPP[d]));
      }
    }
    float sg[2] = {0.0f, 0.0f};
    uint8_t fc[2] = {0, 0};
    if (kNudge == 1) {
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(nudge_sigma) + n);
      const unsigned short f2 =
          __ldg(reinterpret_cast<const unsigned short*>(nudge_face) + n);
      sg[0] = s2.x;
      sg[1] = s2.y;
      fc[0] = (uint8_t)(f2 & 0xFFu);
      fc[1] = (uint8_t)(f2 >> 8);
    }
    uint32_t p[19];  // the pulled pairs: cell x in the low half
#pragma unroll
    for (int d = 0; d < 19; ++d) {
      if (CX[d] == 0) {
        p[d] = w[d];
      } else if (CX[d] > 0) {  // sources x - 1, x
        uint32_t l = __shfl_up_sync(0xFFFFFFFFu, w[d], 1);
        if (left) l = side[d];
        p[d] = __byte_perm(l, w[d], 0x5432);
      } else {  // sources x + 1, x + 2
        uint32_t r = __shfl_down_sync(0xFFFFFFFFu, w[d], 1);
        if (right) r = side[d];
        p[d] = __byte_perm(w[d], r, 0x5432);
      }
    }
    if (bounce) {
#pragma unroll
      for (int d = 1; d < 19; ++d) {
        const int bit = nb_bit(-CZ[d], -CY[d], -CX[d]);
        const uint32_t m = (0u - ((srca >> bit) & 1u)) & 0x0000FFFFu |
                           (0u - ((srcb >> bit) & 1u)) & 0xFFFF0000u;
        p[d] = (p[d] & ~m) | (own[OPP[d]] & m);
      }
    }

    // ---- each cell's collision, one after the other; a direction's two
    // ---- codes are stored as one word
    // (y, x) anew in each plane, so that the compiler does not keep the
    // forcing's addresses of a column across the march (registers)
    const int yz = remade(y), xz = remade(x);
    auto collide = [&](const float(&f)[19], int h, auto&& store) {
      collide_cell<C, kForce, kNudge, kSponge, false, false>(
          f, h, z, yz, xz + h, Y, X, dyn, kNudge == 1 ? sg : nullptr,
          kNudge == 1 ? fc : nullptr, uw, ue, us, un, ut, ub, sponge_z,
          nudge_vertical, subgrid, omega, tau0, tau0_sq, ThermArgs{},
          [](float&, float&, float&, float, float, float, float) {},
          [](float, float, float) { return 0.0f; }, store);
    };
    // while one cell collides, the other's codes wait two to a register:
    // x + 1's pulled codes (pb) during x's collision, then x's results
    // (oa) during x + 1's
    float f[19];
#pragma unroll
    for (int d = 0; d < 19; ++d) f[d] = C::dec_lo(p[d]);
    uint32_t pb[10], oa[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      pb[k] = __byte_perm(p[2 * k], 2 * k + 1 < 19 ? p[2 * k + 1] : 0u, 0x7632);
      oa[k] = 0u;
    }
    if (ca) {
      float prev = 0.0f;
      collide(f, 0, [&](int d, float v) {
        if (d & 1) oa[d / 2] = C::enc2(prev, v);
        else if (d == 18) oa[9] = C::enc2(v, 0.0f);
        else prev = v;
      });
    }
    if (live) {
      // the halves that do not collide store 0 here: TYPE_S's code, and
      // TYPE_E's until its own code goes over it below
      uint32_t* __restrict__ out = pinned(fb + n);
      const uint32_t keep = (ca ? 0x0000FFFFu : 0u) | (cb ? 0xFFFF0000u : 0u);
      auto put = [&](int d, float vb) {
        *at(out, d) = __byte_perm(oa[d / 2], C::enc2(vb, 0.0f),
                                  d & 1 ? 0x5432 : 0x5410) & keep;
      };
      if (cb) {
#pragma unroll
        for (int k = 0; k < 10; ++k) {
          f[2 * k] = C::dec_lo(pb[k]);
          if (2 * k + 1 < 19) f[2 * k + 1] = C::dec_hi(pb[k]);
        }
        collide(f, 1, put);
      } else {
#pragma unroll
        for (int d = 0; d < 19; ++d) put(d, 0.0f);
      }
      if (ea || eb) {  // TYPE_E: the cell's stored codes go back unchanged
        // (its words' pointer made anew: none is held across the collisions)
        const uint32_t* __restrict__ own = pinned(fa + n);
        uint32_t e[19];
#pragma unroll
        for (int d = 0; d < 19; ++d) e[d] = __ldg(at(own, d));
#pragma unroll
        for (int d = 0; d < 19; ++d) {
          uint16_t* __restrict__ h = reinterpret_cast<uint16_t*>(at(out, d));
          if (ea) h[0] = (uint16_t)(e[d] & 0xFFFFu);
          if (eb) h[1] = (uint16_t)(e[d] >> 16);
        }
      }
    }
    if (more) {
      if (pos >= 0) ring[sm][pos] = v;
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int t = sm;
    sm = s0;
    s0 = sp;
    sp = t;
  }
}

// One plain step of a paired-codec configuration on the paired instance
// (the caller checks pair_step).
template <class C, bool kForce, int kNudge, int kSponge>
cudaError_t sc_launch_pair(const ScArgs& a, cudaStream_t stream) {
  constexpr TileShape t = pair_cells(pair_shape());
  if ((long long)a.Z * a.Y * a.X > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((a.X + t.tx - 1) / t.tx, (a.Y + t.ty - 1) / t.ty,
                  (a.Z + t.kz - 1) / t.kz);
  stream_collide_tiled_kernel_pair<C, kForce, kNudge, kSponge>
      <<<grid, dim3(pair_shape().tx, pair_shape().ty), 0, stream>>>(
          static_cast<const uint32_t*>(a.fa), static_cast<uint32_t*>(a.fb),
          a.flags, a.dyn, a.nudge_sigma, a.nudge_face, a.uw, a.ue, a.us, a.un,
          a.ut, a.ub, a.sponge_z, a.Z, a.Y, a.X, a.nudge_vertical, a.subgrid,
          a.omega, a.tau0, a.tau0_sq);
  return cudaGetLastError();
}

// Whether a plain step (no wall model, SRT, not thermal, not halo mode) in
// a paired codec takes the paired instance: X even, and the words it loads
// and stores aligned (the DDFs to 4 bytes, nudge_sigma to 8 and nudge_face
// to 2, as every allocation of torch is).  ops/stream_collide.py's
// paired_step is the same test.
inline bool pair_step(const ScArgs& a) {
  auto aligned = [](const void* p, uintptr_t n) {
    return ((uintptr_t)p & (n - 1)) == 0;
  };
  return a.X % 2 == 0 && aligned(a.fa, 4) && aligned(a.fb, 4) &&
         aligned(a.nudge_sigma, 8) && aligned(a.nudge_face, 2);
}

}  // namespace luw
