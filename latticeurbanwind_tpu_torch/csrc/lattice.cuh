// D3Q19 helpers shared by the stream-collide and averaging kernels: cell
// types, the periodic wrap, the wall models' streaming and stress, and the
// z-halo planes of the step's halo mode.
//
// Replaces: the wall-model branches of
// latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step (specular
// mirrors :618-650, Schumann stress :678-703) and of
// latticeurbanwind_tpu/ops/avg_kernel.py::make_avg_update (:179-192,
// :218-234), which compute the same terms; and the halo mode's z-neighbour
// planes of make_pallas_step (:1032-1042, :1222-1241).
//
// Directions are the cz-grouped D3Q19 order of lbm/lattice.py.  The tables
// are local arrays in each function: the callers' loops over d are
// unrolled, so every lookup folds to a constant.  The wall models' choices,
// solid_source_pick and wall_stress_at, take accessors: the step's tiled
// body and K-AVG (stream_collide_tiled.cuh, avg_update.cu) test their
// neighbourhood mask, and a halo-mode slab reads a partner in a halo plane
// through the element accessor.  tests/test_torch_stream_collide.py holds
// every copy of a table to lbm/lattice.py and both helpers to the
// conditions, priority, planes and stress arithmetic of the plain version
// (lbm/fields.py pull, wall_stress).
//
// Bound: none of these is; neither kernel reads the flags from device
// memory (they come from a shared-memory ring), and a mirror reads a DDF
// element in place of the bounce-back one.

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

// The element of the previous step's DDFs that direction d takes at cell n
// = (z, y, x) when its pull source src = (zs, ys, xs) = n - c_d (wrapped) is
// solid.  kWall 0: halfway bounce-back, f_opp at n.  kWall 1 (wall_model)
// and 2 (wall_sides) take the first admissible specular mirror instead, in
// the priority of the reference's selects (y face, then x face, then the
// ground, the later one winning):
//   ground (cz = +1):  f_(cx,cy,-1) of the own plane at (z, ys, xs);
//   x face (cx != 0):  f_(-cx,cy,cz) at (zs, ys, x);
//   y face (cy != 0):  f_(cx,-cy,cz) at (zs, y, xs);
// each only where that partner cell is fluid.  The partners are the source
// with one coordinate set back to the cell's own, so they wrap as the pull
// does; each is reached from src by the offset to_ground, to_xface or
// to_yface.  `solid(p, dz, dy, dx)` says whether the partner at cell offset
// p, which lies (dz, dy, dx) from the cell, is solid (the callers test a
// bit of their neighbourhood mask); `at(ch, p, dz)` names channel ch of the
// cell at offset p, which lies in the plane dz from the cell's: the ground
// partner and the bounce-back element lie in the cell's own plane, the x-
// and y-face partners in the source's, which in a halo-mode slab may be a
// halo plane (a cz = +1 (-1) direction's face mirrors are cz = +1 (-1)
// directions too, so the 5 channels of a halo plane hold them).  I is the
// cell offsets' type.  Returning an element, not a value, leaves the caller
// one load and one decode per direction: a helper returning decoded values
// made the fp16c instances decode twice (+52% per step on the card,
// PERF.md).
template <int kWall, class I, class Solid, class At>
__device__ __forceinline__ auto solid_source_pick(
    const Solid& solid, const At& at, int d, I n, I src, I to_ground,
    I to_xface, I to_yface) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  // mirrors about the ground (cz = +1 only), an x face and a y face
  const int MZ[19] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, 14, 16, 15, 18, 17, -1, -1, -1, -1, -1};
  const int MX[19] = {-1, 2, 1, -1, -1, 8, 7, 6, 5, -1, 11, 10, -1, -1, -1, 16, 15, -1, -1};
  const int MY[19] = {-1, -1, -1, 4, 3, 7, 8, 5, 6, -1, -1, -1, 13, 12, -1, -1, -1, 18, 17};
  if (kWall >= 1 && CZ[d] == 1) {
    const I p = src + to_ground;
    if (!solid(p, 0, -CY[d], -CX[d])) return at(MZ[d], p, 0);
  }
  if (kWall == 2 && CX[d] != 0) {
    const I p = src + to_xface;
    if (!solid(p, -CZ[d], -CY[d], 0)) return at(MX[d], p, -CZ[d]);
  }
  if (kWall == 2 && CY[d] != 0) {
    const I p = src + to_yface;
    if (!solid(p, -CZ[d], 0, -CX[d])) return at(MY[d], p, -CZ[d]);
  }
  return at(OPP[d], n, 0);
}

// The z-halo planes of a halo-mode step (K8, the Pallas kernel's halo_mode:
// make_pallas_step :1032-1042, :1222-1241), one z slab of a domain split
// over several devices.  A pull whose z source leaves the slab's [0, Z)
// reads the plane the neighbouring slab supplies instead of wrapping: fp
// holds the 5 cz = +1 channels (9-13) of the plane below (z = -1), fm the 5
// cz = -1 channels (14-18) of the plane above (z = Z), each channel a
// contiguous (Y, X) plane `fps` / `fms` elements after the previous one (a
// view into the neighbour's DDFs, or a copy); flb / fla are the flags of
// those planes; gp / gm the thermal cz = +1 / -1 channel (5 / 6) of g of
// the plane below / above.  The wall models' mirror partners of a cz = +1
// (-1) direction are cz = +1 (-1) directions too, so 5 channels suffice.
struct HaloArgs {
  const void* fp;
  const void* fm;
  long long fps, fms;
  const uint8_t* flb;
  const uint8_t* fla;
  const void* gp;
  const void* gm;
};

// The wall models' Schumann stress on the force at a fluid cell, from its
// streamed (unforced) velocity u: -cd rho |u_h| u_h when the cell below
// (z - 1) is solid; with kWall 2 and cd_sides > 0, -cd_sides rho |u_t| u_t
// beside an x-face solid neighbour (along y and z) and a y-face one (along
// x and z).  `flag_at(dz, dy, dx)` gives the flags (at least their kTypeS
// bit) of the cell (dz, dy, dx) away, which the callers take from their
// neighbourhood mask (in a halo-mode slab the ring holds the halo planes'
// flags).  The Pallas step's evaluation order (:678-703).
template <int kWall, class FlagAt>
__device__ __forceinline__ void wall_stress_at(
    float& Fx, float& Fy, float& Fz, float ux, float uy, float uz, float rho,
    const FlagAt& flag_at, float cd, float cd_sides) {
  if (kWall == 0) return;
  if (flag_at(-1, 0, 0) & kTypeS) {
    const float cw = cd * rho * sqrtf(ux * ux + uy * uy);
    Fx -= cw * ux;
    Fy -= cw * uy;
  }
  if (kWall == 2 && cd_sides > 0.0f) {
    const bool gx = (flag_at(0, 0, -1) | flag_at(0, 0, 1)) & kTypeS;
    const bool gy = (flag_at(0, -1, 0) | flag_at(0, 1, 0)) & kTypeS;
    const float cwx = gx ? cd_sides * rho * sqrtf(uy * uy + uz * uz) : 0.0f;
    const float cwy = gy ? cd_sides * rho * sqrtf(ux * ux + uz * uz) : 0.0f;
    Fx -= cwy * ux;
    Fy -= cwx * uy;
    Fz -= (cwx + cwy) * uz;
  }
}

}  // namespace luw
