// Fused D3Q19 stream-collide step for Hopper (sm_90a): the C entry point,
// the instances without a wall model under SRT, and the VK inlet site pass.
//
// Replaces: latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step,
// the Pallas TPU kernel that advances the lattice by one time step.  The
// step kernel is the tiled body of stream_collide_tiled.cuh (its phases,
// bound and design are described there and in stream_collide.cuh); this
// unit instantiates its plain family -- no wall model, SRT, not thermal:
// every storage codec, with and without the volume force (nudging and the
// sponge at run time) -- and hands the
// wall-model and TRT configurations to stream_collide_wall.cu, the thermal
// ones to stream_collide_thermal.cu and the halo-mode steps of a split
// domain (K8) to stream_collide_halo.cu, each family with its compile-time
// shape.
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
// +64% (fp16c) as a __noinline__ tail call.  The VK site pass touches only
// the boundary shell, O(N^(2/3)) cells.  In a halo-mode slab the faces lie
// inside the ghost layers: the pass covers the shell of the box without them
// (offsets gy / gx, 0 outside halo mode), and the runner gives a slab only
// the sites of the faces it owns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"
#include "stream_collide.cuh"
#include "stream_collide_tiled.cuh"

namespace luw {

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

// Whether the cell (z, y, x) of the (Z, Y, X) box lies on a masked face, the
// row and lane faces gy / gx inside the y / x edges.
__device__ __forceinline__ bool vk_on_site(const VkMasks& vm, int z, int y,
                                           int x, int Z, int Y, int X, int gy,
                                           int gx) {
  return (z == Z - 1 && vm.ut) || (z == 0 && vm.ub) || (y == gy && vm.us) ||
         (y == Y - 1 - gy && vm.un) || (x == gx && vm.uw) ||
         (x == X - 1 - gx && vm.ue);
}

// Every site of the cell in the Pallas order: planes, rows, lanes; the row
// and lane faces gy / gx inside the y / x edges.
template <class C>
__device__ __forceinline__ void vk_sites(
    typename C::T (&o)[19], const VkMasks& vm, int z, int y, int x, int Z,
    int Y, int X, int gy, int gx, const float* __restrict__ uw,
    const float* __restrict__ ue, const float* __restrict__ us,
    const float* __restrict__ un, const float* __restrict__ ut,
    const float* __restrict__ ub) {
  const long long plane = (long long)Y * X;
  const long long yx = (long long)y * X + x;
  if (z == Z - 1 && vm.ut)
    vk_blend<C>(o, vm.ut[yx], ut[yx], ut[plane + yx], ut[2 * plane + yx]);
  if (z == 0 && vm.ub)
    vk_blend<C>(o, vm.ub[yx], ub[yx], ub[plane + yx], ub[2 * plane + yx]);
  const long long zx = (long long)z * X + x;
  const long long rx = (long long)z * 3 * X + x;
  if (y == gy && vm.us)
    vk_blend<C>(o, vm.us[zx], us[rx], us[rx + X], us[rx + 2 * X]);
  if (y == Y - 1 - gy && vm.un)
    vk_blend<C>(o, vm.un[zx], un[rx], un[rx + X], un[rx + 2 * X]);
  const long long zy = (long long)z * Y + y;
  const long long ry = (long long)z * 3 * Y + y;
  if (x == gx && vm.uw)
    vk_blend<C>(o, vm.uw[zy], uw[ry], uw[ry + Y], uw[ry + 2 * Y]);
  if (x == X - 1 - gx && vm.ue)
    vk_blend<C>(o, vm.ue[zy], ue[ry], ue[ry + Y], ue[ry + 2 * Y]);
}

// The VK site pass over the boundary shell of the (Z, Y, X) box, one thread
// per cell: the z = 0 and z = Z-1 planes, then the y = 0 and y = Y-1 rows of
// the interior z, then the x = 0 and x = X-1 lanes of the interior z and y
// (a box thinner than 3 cells lists each of its cells once).  A cell on a
// masked face gets all of its sites, in order, from the step's outputs.
// The box is the (Z, Y - 2 gy, X - 2 gx) one inside the ghost layers of a
// halo-mode slab (gy = gx = 0 otherwise).
template <class C>
__global__ void __launch_bounds__(kScThreads)
vk_site_kernel(typename C::T* __restrict__ fb, VkMasks vm,
               const float* __restrict__ uw, const float* __restrict__ ue,
               const float* __restrict__ us, const float* __restrict__ un,
               const float* __restrict__ ut, const float* __restrict__ ub,
               int Z, int Y, int X, int gy, int gx) {
  using T = typename C::T;
  const int Yb = Y - 2 * gy, Xb = X - 2 * gx;  // the box inside the ghosts
  const int Zi = max(Z - 2, 0), Yi = max(Yb - 2, 0);
  const long long nP = (long long)Yb * Xb, nR = (long long)Zi * Xb,
                  nL = (long long)Zi * Yi;
  const long long sP = min(Z, 2) * nP, sR = min(Yb, 2) * nR,
                  sL = min(Xb, 2) * nL;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int z, y, x;
  if (i < sP) {
    z = i < nP ? 0 : Z - 1;
    i %= nP;
    y = (int)(i / Xb);
    x = (int)(i % Xb);
  } else if ((i -= sP) < sR) {
    y = i < nR ? 0 : Yb - 1;
    i %= nR;
    z = 1 + (int)(i / Xb);
    x = (int)(i % Xb);
  } else if ((i -= sR) < sL) {
    x = i < nL ? 0 : Xb - 1;
    i %= nL;
    z = 1 + (int)(i / Yi);
    y = 1 + (int)(i % Yi);
  } else {
    return;
  }
  y += gy;
  x += gx;
  if (!vk_on_site(vm, z, y, x, Z, Y, X, gy, gx)) return;
  const long long N = (long long)Z * Y * X;
  const long long n = ((long long)z * Y + y) * X + x;
  T o[19];
#pragma unroll
  for (int d = 0; d < 19; ++d) o[d] = fb[d * N + n];
  vk_sites<C>(o, vm, z, y, x, Z, Y, X, gy, gx, uw, ue, us, un, ut, ub);
#pragma unroll
  for (int d = 0; d < 19; ++d) fb[d * N + n] = o[d];
}

// One SRT step without a wall model (the plain family: nudging and the
// sponge as run-time switches, which chip_sweep.py measured no slower than
// compile-time ones); thermal steps go to the instances of
// stream_collide_thermal.cu, the wall models and TRT to those of
// stream_collide_wall.cu.
template <class C>
cudaError_t sc_dispatch_force(const ScArgs& a, cudaStream_t stream) {
  if (a.thermal) return sc_dispatch_thermal<C>(a, stream);
  if (a.wall || a.trt) return sc_dispatch_wall<C>(a, stream);
  if (!a.volume_force) {
    if (a.has_nudge || a.has_sponge) return cudaErrorInvalidValue;
    return sc_launch_tiled<C, false, 0, 0, 0, false, false>(a, stream);
  }
  return sc_launch_tiled<C, true, 2, 2, 0, false, false>(a, stream);
}

// One step in storage codec C (a halo-mode one where halo planes are
// given), then the VK site pass when any mask is given; gy / gx are the
// ghost widths of a halo-mode slab's plane.
template <class C>
cudaError_t sc_dispatch(const ScArgs& a, int gy, int gx, cudaStream_t stream) {
  const bool halo = a.halo.fp != nullptr;
  const cudaError_t err =
      halo ? sc_dispatch_halo<C>(a, stream) : sc_dispatch_force<C>(a, stream);
  const VkMasks& m = a.vm;
  if (err != cudaSuccess || !(m.uw || m.ue || m.us || m.un || m.ut || m.ub))
    return err;
  if (!halo) gy = gx = 0;
  const long long Yb = a.Y - 2 * gy, Xb = a.X - 2 * gx;
  const long long Zi = a.Z > 2 ? a.Z - 2 : 0, Yi = Yb > 2 ? Yb - 2 : 0;
  const long long shell = (a.Z > 1 ? 2 : 1) * Yb * Xb +
                          (Yb > 1 ? 2 : 1) * Zi * Xb +
                          (Xb > 1 ? 2 : 1) * Zi * Yi;
  const unsigned int blocks =
      (unsigned int)((shell + kScThreads - 1) / kScThreads);
  vk_site_kernel<C><<<blocks, kScThreads, 0, stream>>>(
      static_cast<typename C::T*>(a.fb), a.vm, a.uw, a.ue, a.us, a.un, a.ut,
      a.ub, a.Z, a.Y, a.X, gy, gx);
  return cudaGetLastError();
}

}  // namespace luw

// storage: 0 = f32, 1 = bf16, 2 = f16 (FP16S), 3 = fp16c.  mask_* are the VK
// inlet site masks (null where a face carries no site; all null launches
// the VK-off kernel).  wall: 0 none, 1 wall_model (ground specular +
// Schumann stress at wall_cd), 2 wall_sides too (side stress at
// wall_cd_sides); trt: TRT instead of SRT collision.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch (0
// on success).  thermal: also step the D3Q7 populations ga -> gb (storage
// type, (7, Z, Y, X)) at omega_t, with the sponge's temperature target tt
// (Y, X; null without a sponge) and the Boussinesq term beta * (T - t_avg);
// the VK site pass leaves g alone.  fp_halo non-null: a halo-mode step of
// one z slab of a split domain (lattice.cuh HaloArgs: fp_halo / fm_halo the
// 5 cz = +1 / -1 channels of the planes below / above with channel strides
// fp_stride / fm_stride in elements, flb / fla their flags, gp_halo /
// gm_halo their thermal g channel), whose VK sites lie gy / gx inside the
// y / x edges of its ghost-extended plane.
extern "C" int luw_stream_collide(
    const void* fa, void* fb, const void* flags, const void* dyn,
    const void* nudge_sigma, const void* nudge_face, const void* uw,
    const void* ue, const void* us, const void* un, const void* ut,
    const void* ub, const void* sponge_z, const void* mask_uw,
    const void* mask_ue, const void* mask_us, const void* mask_un,
    const void* mask_ut, const void* mask_ub, const void* ga, void* gb,
    const void* tt, int Z, int Y, int X, int storage, int volume_force,
    int has_nudge, int has_sponge, int nudge_vertical, int subgrid,
    float omega, float tau0, float tau0_sq, int wall, int trt, float wall_cd,
    float wall_cd_sides, int thermal, float omega_t, float beta, float t_avg,
    const void* fp_halo, const void* fm_halo, long long fp_stride,
    long long fm_stride, const void* flb, const void* fla,
    const void* gp_halo, const void* gm_halo, int gy, int gx, void* stream) {
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
  a.wall = wall;
  a.trt = trt;
  a.wall_cd = wall_cd;
  a.wall_cd_sides = wall_cd_sides;
  a.thermal = thermal;
  a.th = {ga, gb, F(tt), omega_t, beta, t_avg};
  a.halo = {fp_halo, fm_halo, fp_stride, fm_stride,
            static_cast<const uint8_t*>(flb), static_cast<const uint8_t*>(fla),
            gp_halo, gm_halo};
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (storage) {
    case 0: err = luw::sc_dispatch<luw::CodecF32>(a, gy, gx, st); break;
    case 1: err = luw::sc_dispatch<luw::CodecBF16>(a, gy, gx, st); break;
    case 2: err = luw::sc_dispatch<luw::CodecF16>(a, gy, gx, st); break;
    case 3: err = luw::sc_dispatch<luw::CodecFP16C>(a, gy, gx, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
