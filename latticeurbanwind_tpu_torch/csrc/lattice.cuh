// D3Q19 helpers shared by the stream-collide and averaging kernels: cell
// types, the periodic wrap, and the wall models' streaming and stress.
//
// Replaces: the wall-model branches of
// latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step (specular
// mirrors :618-650, Schumann stress :678-703) and of
// latticeurbanwind_tpu/ops/avg_kernel.py::make_avg_update (:179-192,
// :218-234), which compute the same terms.
//
// Directions are the cz-grouped D3Q19 order of lbm/lattice.py.  The tables
// are local arrays in each function: the callers' loops over d are
// unrolled, so every lookup folds to a constant.
//
// Bound: none of these is; the mirrors add up to three flag reads per
// solid-adjacent direction (and read a mirror DDF in place of the bounce-back
// one), served mostly by L1/L2 next to the neighbour reads the pull already
// makes.

#pragma once

#include <stdint.h>

#include "codec.cuh"

namespace luw {

constexpr uint8_t kTypeS = 0x01;
constexpr uint8_t kTypeE = 0x02;
constexpr float kCs = 0.57735027f;

__device__ __forceinline__ float clamp_cs(float v) {
  return fminf(fmaxf(v, -kCs), kCs);
}

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// The element of the previous step's DDFs that direction d takes at cell
// n = (z, y, x) when its pull source src = (zs, ys, xs) = x - c_d (wrapped)
// is solid.  kWall 0: halfway bounce-back, f_opp at n.  kWall 1
// (wall_model) and 2 (wall_sides) take the first admissible specular
// mirror instead, in the priority of the reference's selects (y face, then
// x face, then the ground, the later one winning):
//   ground (cz = +1):  f_(cx,cy,-1) of the own plane at (z, ys, xs);
//   x face (cx != 0):  f_(-cx,cy,cz) at (zs, ys, x);
//   y face (cy != 0):  f_(cx,-cy,cz) at (zs, y, xs);
// each only where that partner cell is fluid.  The partners are the source
// with one coordinate set back to the cell's own, so they wrap as the pull
// does.  Returning an index, not a value, leaves the caller one load and one
// decode per direction: a helper returning decoded values made the fp16c
// instances decode twice (+52% per step on the card, PERF.md).
template <int kWall>
__device__ __forceinline__ long long solid_source_index(
    const uint8_t* __restrict__ flags, int d, long long n, long long src,
    int z, int y, int x, int zs, int ys, int xs, int X, long long plane,
    long long N) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  // mirrors about the ground (cz = +1 only), an x face and a y face
  const int MZ[19] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, 14, 16, 15, 18, 17, -1, -1, -1, -1, -1};
  const int MX[19] = {-1, 2, 1, -1, -1, 8, 7, 6, 5, -1, 11, 10, -1, -1, -1, 16, 15, -1, -1};
  const int MY[19] = {-1, -1, -1, 4, 3, 7, 8, 5, 6, -1, -1, -1, 13, 12, -1, -1, -1, 18, 17};
  if (kWall >= 1 && CZ[d] == 1) {
    const long long p = src + (z - zs) * plane;
    if (!(flags[p] & kTypeS)) return MZ[d] * N + p;
  }
  if (kWall == 2 && CX[d] != 0) {
    const long long p = src + (x - xs);
    if (!(flags[p] & kTypeS)) return MX[d] * N + p;
  }
  if (kWall == 2 && CY[d] != 0) {
    const long long p = src + (long long)(y - ys) * X;
    if (!(flags[p] & kTypeS)) return MY[d] * N + p;
  }
  return OPP[d] * N + n;
}

// The wall models' Schumann stress on the force at a fluid cell, from its
// streamed (unforced) velocity u: -cd rho |u_h| u_h when the cell below
// (z - 1, periodic) is solid; with kWall 2 and cd_sides > 0, -cd_sides rho
// |u_t| u_t beside an x-face solid neighbour (along y and z) and a y-face one
// (along x and z).  The Pallas step's evaluation order (:678-703).
template <int kWall>
__device__ __forceinline__ void wall_stress(
    float& Fx, float& Fy, float& Fz, float ux, float uy, float uz, float rho,
    const uint8_t* __restrict__ flags, int z, int y, int x, int Z, int Y,
    int X, float cd, float cd_sides) {
  if (kWall == 0) return;
  const long long plane = (long long)Y * X;
  if (flags[wrap(z - 1, Z) * plane + (long long)y * X + x] & kTypeS) {
    const float cw = cd * rho * sqrtf(ux * ux + uy * uy);
    Fx -= cw * ux;
    Fy -= cw * uy;
  }
  if (kWall == 2 && cd_sides > 0.0f) {
    const long long zp = z * plane;
    const long long row = zp + (long long)y * X;
    const bool gx =
        (flags[row + wrap(x - 1, X)] | flags[row + wrap(x + 1, X)]) & kTypeS;
    const bool gy = (flags[zp + (long long)wrap(y - 1, Y) * X + x] |
                     flags[zp + (long long)wrap(y + 1, Y) * X + x]) &
                    kTypeS;
    const float cwx = gx ? cd_sides * rho * sqrtf(uy * uy + uz * uz) : 0.0f;
    const float cwy = gy ? cd_sides * rho * sqrtf(ux * ux + uz * uz) : 0.0f;
    Fx -= cwy * ux;
    Fy -= cwx * uy;
    Fz -= (cwx + cwy) * uz;
  }
}

}  // namespace luw
