// The thermal D3Q7 sub-lattice of the stream-collide step: one cell's g
// populations streamed, relaxed and stored, returning the cell's
// temperature for the Boussinesq term of the f collision.
//
// Replaces: the thermal branch of
// latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step (:732-807,
// outputs :909-913), per cell and not tile by tile: none of the Pallas
// kernel's g0/gp/gm split groups, carried rows or plane scratch exists here.
//
// Per cell (directions in the D3Q7 order of lbm/lattice.py: rest, +x, -x,
// +y, -y, +z, -z):
//   * a TYPE_T cell keeps its stored g bit for bit and reports T = 1 + the
//     sum of its own populations;
//   * any other cell pulls g_d from x - c_d (periodic), or its own
//     g_opp(d) where that source is solid (halfway bounce-back; the wall
//     models' mirrors do not apply to g), T = 1 + sum g;
//   * the top sponge relaxes T toward tt(y, x) at rate sig_t (the caller
//     passes 0 at TYPE_E cells and without a sponge);
//   * g_eq = w0 (T - 1), ws (T - 1) +- T u_axis / 2 with w0 = 1/4, ws = 1/8
//     and u the streamed, unforced velocity (at TYPE_E cells the velocity of
//     the cell's own frozen f);
//   * g_post = (1 - omega_t) g + omega_t g_eq, encoded by the step's codec.
//
// The tiled body (stream_collide_tiled.cuh) takes this work in two halves,
// thermal_pull_index with its f pulls and thermal_finish after the forces,
// which ends in thermal_relax.  In a halo-mode slab the z pulls that leave
// the slab read the neighbouring slabs' planes (HaloArgs of lattice.cuh)
// instead of wrapping, through the element accessor of thermal_pull_index.
//
// Bound: device memory, with the step: 2 * 7 * sizeof(storage) bytes per
// cell on top of the step's 2 * 19 * sizeof(storage) + 1; ~40 flops.  The g
// relax runs between the step's forces and its Guo half-step and writes g
// before the f collision starts, so beyond its own few values only T
// outlives it.

#pragma once

#include <stdint.h>

#include "codec.cuh"
#include "lattice.cuh"

namespace luw {

constexpr uint8_t kTypeT = 0x04;

// The thermal arguments of one step (untyped: the kernel casts ga/gb to its
// codec's storage type).  tt is null without a sponge.
struct ThermArgs {
  const void* ga;
  void* gb;
  const float* tt;
  float omega_t, beta, t_avg;
};

template <class C>
__device__ __forceinline__ void thermal_zero(typename C::T* __restrict__ gb,
                                             long long n, long long N) {
#pragma unroll
  for (int d = 0; d < 7; ++d) gb[d * N + n] = C::enc(0.0f);
}

// The relax half of a cell's D3Q7 update, from its pulled populations g
// (decoded): T = 1 + sum g, the sponge toward tt(y, x) at rate sig_t (tt
// null: none), g_post = (1 - omega_t) g + omega_t g_eq written to gb at
// cell n (channel stride N); returns T.  I is the cell offset's type.
template <class C, class I>
__device__ __forceinline__ float thermal_relax(
    const float (&g)[7], typename C::T* __restrict__ gb, I n, long long N,
    int y, int x, int X, float ux, float uy, float uz, float sig_t,
    const float* __restrict__ tt, float omega_t) {
  float T = g[0];
#pragma unroll
  for (int d = 1; d < 7; ++d) T += g[d];
  T += 1.0f;
  if (tt != nullptr) T += sig_t * (tt[(long long)y * X + x] - T);

  const float tm1 = T - 1.0f;
  const float tq = 0.125f * tm1;
  const float one_m_w = 1.0f - omega_t;
  const float cu[3] = {0.5f * T * ux, 0.5f * T * uy, 0.5f * T * uz};
  gb[n] = C::enc(one_m_w * g[0] + omega_t * (0.25f * tm1));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int d = 1 + 2 * a;
    gb[d * N + n] = C::enc(one_m_w * g[d] + omega_t * (tq + cu[a]));
    gb[(d + 1) * N + n] = C::enc(one_m_w * g[d + 1] + omega_t * (tq - cu[a]));
  }
  return T;
}

// The tiled body's two halves of a cell's D3Q7 update, so that the g loads
// go out with the f loads and the relax runs after the forces, where the
// Pallas kernel evaluates it.  thermal_pull_index: the element of g that
// D3Q7 direction d takes at cell n -- its own g_d at a TYPE_T cell (kept bit
// for bit), else g_d of the source n + src_off or, where that source is
// solid, its own g_opp(d) -- as `at(ch, p, dz)` names channel ch of the cell
// at offset p in the plane dz from the cell's (the source's plane, which in
// a halo-mode slab may be a halo plane, or the cell's own).
template <class I, class At>
__device__ __forceinline__ auto thermal_pull_index(int d, uint8_t fl,
                                                   bool src_solid, I n,
                                                   I src_off, const At& at) {
  const int CZ[7] = {0, 0, 0, 0, 0, 1, -1};
  const int OPP[7] = {0, 2, 1, 4, 3, 6, 5};
  if (d == 0 || (fl & kTypeT)) return at(d, n, 0);
  return src_solid ? at(OPP[d], n, 0) : at(d, n + src_off, -CZ[d]);
}

// thermal_finish: from the pulled stored values graw, a TYPE_T cell writes
// them back unchanged and reports T = 1 + the sum of its populations; any
// other cell decodes them and relaxes (thermal_relax).  Returns T.
template <class C, class I>
__device__ __forceinline__ float thermal_finish(
    const typename C::T (&graw)[7], uint8_t fl, typename C::T* __restrict__ gb,
    I n, long long N, int y, int x, int X, float ux, float uy, float uz,
    float sig_t, const float* __restrict__ tt, float omega_t) {
  if (fl & kTypeT) {
    float t_own = 0.0f;
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      gb[d * N + n] = graw[d];
      t_own = d == 0 ? C::dec(graw[d]) : t_own + C::dec(graw[d]);
    }
    return t_own + 1.0f;
  }
  float g[7];
#pragma unroll
  for (int d = 0; d < 7; ++d) g[d] = C::dec(graw[d]);
  return thermal_relax<C>(g, gb, n, N, y, x, X, ux, uy, uz, sig_t, tt,
                          omega_t);
}

}  // namespace luw
