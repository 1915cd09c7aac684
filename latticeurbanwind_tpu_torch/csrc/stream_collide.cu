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
// The VK inlet site pass (K6; the Pallas kernel's `vk` spec,
// make_pallas_step :915-978): at the boundary faces that carry a site mask,
// the cell's encoded outputs are overwritten by enc(m * feq_vk(u_face) +
// (1 - m) * dec(out)), where feq_vk is the DDF-shifted equilibrium at rho =
// 1 of the FaceBC velocity at that face cell and m the site's 0/1 mask.
// Sites apply in the Pallas order -- planes (ut at z = Z-1, ub at z = 0),
// then rows (us at y = 0, un at y = Y-1), then lanes (uw at x = 0, ue at x =
// X-1) -- each reading back the output the earlier ones left, so the west
// and east lanes own the corners.  The Pallas kernel applies them in its
// epilogue; here they are a pass launched right after the step on the same
// stream (luw_stream_collide), or alone (luw_vk_sites), which reads the
// step's stored outputs and overwrites them -- the same values, since the
// epilogue too reads back encoded outputs.  Fused into the step the sites
// cost +14% (bf16) to +72% (fp16c), and +2% to +64% as a __noinline__ tail
// call (PERF.md), so the step kernel stays as it is.  In a halo-mode slab
// the faces lie inside the ghost layers: the pass covers the faces of the
// box without them (offsets gy / gx, 0 outside halo mode), and the runner
// gives a slab only the sites of the faces it owns.
//
// Bound on the H100: device memory.  The pass reads and writes the 19 DDFs
// of every cell on a masked face and reads a mask value and 3 velocities
// per site: O(N^(2/3)) elements.  On a row or plane face a warp's elements
// are neighbours along x; on a lane face (x = 0, x = X-1) consecutive cells
// lie X elements apart in the SoA layout, so every element read or written
// there costs a 32-byte sector: the lanes are bound by sectors, not by
// elements (chip_smoke.py states both bounds).  Design: one thread per
// (masked-face cell, direction) element, the direction the block's y index,
// over the masked faces' cells only (each once: planes, then the rows
// without the planes' cells, then the lanes without either's); each
// element's blend chain is independent of the other directions, so a
// thread decodes one value and computes one feq_vk term per site, in the
// Pallas evaluation order.  The lanes' cells are listed with the lane
// fastest, so the east cell of row y and the west cell of row y + 1, which
// lie side by side in memory, share a warp and often a sector; a lane warp
// keeps 32 sectors in flight per load.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec.cuh"
#include "stream_collide.cuh"
#include "stream_collide_tiled.cuh"

namespace luw {

// The site pass's threads per block.
constexpr int kVkThreads = 256;

// c.v over the nonzero components of c, in x, y, z order, each rounding
// spelt out (the plain version's _cdot).
__device__ __forceinline__ float cdot_rn(int cx, int cy, int cz, float a,
                                         float b, float c) {
  float s = 0.0f;
  bool any = false;
  if (cx) { s = cx > 0 ? a : -a; any = true; }
  if (cy) { const float t = cy > 0 ? b : -b; s = any ? __fadd_rn(s, t) : t; any = true; }
  if (cz) { const float t = cz > 0 ? c : -c; s = any ? __fadd_rn(s, t) : t; }
  return s;
}

// feq_vk of direction d alone: the DDF-shifted D3Q19 equilibrium at rho = 1
// in the Pallas evaluation order (c3, then for an opposite pair b +- w*cu
// from the pair's odd member), with every rounding spelt out as a separate
// multiply or add (__fmul_rn / __fadd_rn, which nvcc never fuses), so each
// term is the plain version's (ops/stream_collide.py::feq_vk) to the bit.
__device__ __forceinline__ float feq_vk(int d, float ux, float uy, float uz) {
  const int CX[19] = {0, 1, -1, 0, 0, 1, -1, 1, -1, 0, 1, -1, 0, 0, 0, -1, 1, 0, 0};
  const int CY[19] = {0, 0, 0, 1, -1, 1, -1, -1, 1, 0, 0, 0, 1, -1, 0, 0, 0, -1, 1};
  const int CZ[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  const int OPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 14, 15, 16, 17, 18, 9, 10, 11, 12, 13};
  const float W[19] = {1.f / 3.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 18.f,
                       1.f / 36.f, 1.f / 36.f, 1.f / 36.f, 1.f / 36.f};
  // c3 = -3 ((ux ux + uy uy) + uz uz)
  const float c3 = __fmul_rn(
      -3.0f, __fadd_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)),
                       __fmul_rn(uz, uz)));
  float fe = __fmul_rn(1.0f / 3.0f, __fmul_rn(0.5f, c3));
#pragma unroll
  for (int p = 1; p < 19; p += 2) {
    if (d == p || d == OPP[p]) {
      // cu = 3 c.u, b = w ((cu cu + c3) / 2), fe = b +- w cu
      const float cu = __fmul_rn(3.0f, cdot_rn(CX[p], CY[p], CZ[p], ux, uy, uz));
      const float b = __fmul_rn(
          W[p], __fmul_rn(0.5f, __fadd_rn(__fmul_rn(cu, cu), c3)));
      const float wcu = __fmul_rn(W[p], cu);
      fe = d == p ? __fadd_rn(b, wcu) : __fsub_rn(b, wcu);
    }
  }
  return fe;
}

// One VK site on one element: o <- enc(m * feq_vk(u)_d + (1 - m) * dec(o)),
// rounded as the plain version's apply_vk_sites.
template <class C>
__device__ __forceinline__ typename C::T vk_blend(typename C::T o, int d,
                                                  float m, float ux, float uy,
                                                  float uz) {
  return C::enc(__fadd_rn(__fmul_rn(m, feq_vk(d, ux, uy, uz)),
                          __fmul_rn(__fsub_rn(1.0f, m), C::dec(o))));
}

// The cells of the masked faces of the (Z, Y - 2 gy, X - 2 gx) box, each
// once, in three runs: the masked planes' cells (plane, y, x); the masked
// rows' cells that lie on no masked plane (row, z, x); the masked lanes'
// cells that lie on neither (z, y, lane).  A face that coincides with its
// opposite one (a box one cell thin) counts once.  tests/test_torch_vk_inlet.py
// mirrors this map.
struct VkFaces {
  int nplanes, nrows, nlanes;  // distinct masked planes, rows, lanes
  int zlo, nz;                 // the rows' and lanes' z range
  int ylo, ny;                 // the lanes' y range
  int plane_cells, row_cells, cells;
};

__host__ inline VkFaces vk_faces(const VkMasks& vm, int Z, int Y, int X,
                                 int gy, int gx) {
  const int Yb = Y - 2 * gy, Xb = X - 2 * gx;
  VkFaces f;
  f.nplanes = (vm.ub ? 1 : 0) + (vm.ut && (Z > 1 || !vm.ub) ? 1 : 0);
  f.nrows = (vm.us ? 1 : 0) + (vm.un && (Yb > 1 || !vm.us) ? 1 : 0);
  f.nlanes = (vm.uw ? 1 : 0) + (vm.ue && (Xb > 1 || !vm.uw) ? 1 : 0);
  const int zhi = vm.ut ? Z - 1 : Z, yhi = vm.un ? Y - gy - 1 : Y - gy;
  f.zlo = vm.ub ? 1 : 0;
  f.nz = zhi > f.zlo ? zhi - f.zlo : 0;
  f.ylo = gy + (vm.us ? 1 : 0);
  f.ny = yhi > f.ylo ? yhi - f.ylo : 0;
  f.plane_cells = f.nplanes * Yb * Xb;
  f.row_cells = f.nrows * f.nz * Xb;
  f.cells = f.plane_cells + f.row_cells + f.nz * f.ny * f.nlanes;
  return f;
}

// The site pass: thread (i, d) takes direction d = blockIdx.y of the i-th
// masked-face cell (VkFaces) and applies every site of that cell to it, in
// order, from the step's outputs fb.  The row and lane faces lie gy / gx
// inside the y / x edges of a halo-mode slab's plane (0 otherwise).
template <class C>
__global__ void __launch_bounds__(kVkThreads)
vk_site_kernel(typename C::T* __restrict__ fb, VkMasks vm,
               const float* __restrict__ uw, const float* __restrict__ ue,
               const float* __restrict__ us, const float* __restrict__ un,
               const float* __restrict__ ut, const float* __restrict__ ub,
               VkFaces f, int Z, int Y, int X, int gy, int gx) {
  int i = blockIdx.x * kVkThreads + threadIdx.x;
  if (i >= f.cells) return;
  const int d = blockIdx.y;
  const int Yb = Y - 2 * gy, Xb = X - 2 * gx;
  int z, y, x;
  if (i < f.plane_cells) {
    const int k = i / (Yb * Xb), r = i - k * (Yb * Xb);
    z = k == 0 && vm.ub ? 0 : Z - 1;
    y = gy + r / Xb;
    x = gx + r % Xb;
  } else if ((i -= f.plane_cells) < f.row_cells) {
    const int k = i / (f.nz * Xb), r = i - k * (f.nz * Xb);
    y = k == 0 && vm.us ? gy : Y - 1 - gy;
    z = f.zlo + r / Xb;
    x = gx + r % Xb;
  } else {
    i -= f.row_cells;
    const int k = i % f.nlanes, t = i / f.nlanes;
    x = k == 0 && vm.uw ? gx : X - 1 - gx;
    y = f.ylo + t % f.ny;
    z = f.zlo + t / f.ny;
  }
  const int plane = Y * X;
  typename C::T* __restrict__ p =
      fb + ((long long)d * Z * plane + (z * plane + y * X + x));
  typename C::T o = *p;
  const int yx = y * X + x;
  if (z == Z - 1 && vm.ut)
    o = vk_blend<C>(o, d, vm.ut[yx], ut[yx], ut[plane + yx], ut[2 * plane + yx]);
  if (z == 0 && vm.ub)
    o = vk_blend<C>(o, d, vm.ub[yx], ub[yx], ub[plane + yx], ub[2 * plane + yx]);
  const int zx = z * X + x, rx = z * 3 * X + x;
  if (y == gy && vm.us)
    o = vk_blend<C>(o, d, vm.us[zx], us[rx], us[rx + X], us[rx + 2 * X]);
  if (y == Y - 1 - gy && vm.un)
    o = vk_blend<C>(o, d, vm.un[zx], un[rx], un[rx + X], un[rx + 2 * X]);
  const int zy = z * Y + y, ry = z * 3 * Y + y;
  if (x == gx && vm.uw)
    o = vk_blend<C>(o, d, vm.uw[zy], uw[ry], uw[ry + Y], uw[ry + 2 * Y]);
  if (x == X - 1 - gx && vm.ue)
    o = vk_blend<C>(o, d, vm.ue[zy], ue[ry], ue[ry + Y], ue[ry + 2 * Y]);
  *p = o;
}

// Launch the site pass over fb's masked faces (none: no launch).
template <class C>
cudaError_t vk_launch(void* fb, const VkMasks& vm, const float* uw,
                      const float* ue, const float* us, const float* un,
                      const float* ut, const float* ub, int Z, int Y, int X,
                      int gy, int gx, cudaStream_t stream) {
  if ((long long)Z * Y * X > INT_MAX || 2 * gy >= Y || 2 * gx >= X || gy < 0 ||
      gx < 0)
    return cudaErrorInvalidValue;
  const VkFaces f = vk_faces(vm, Z, Y, X, gy, gx);
  if (f.cells == 0) return cudaSuccess;
  const dim3 grid((f.cells + kVkThreads - 1) / kVkThreads, 19);
  vk_site_kernel<C><<<grid, kVkThreads, 0, stream>>>(
      static_cast<typename C::T*>(fb), vm, uw, ue, us, un, ut, ub, f, Z, Y, X,
      gy, gx);
  return cudaGetLastError();
}

// One plain step on the paired instance (stream_collide_tiled.cuh): the
// nudging band as a compile-time switch there, since its inputs are read
// per pair; the sponge at run time.
template <class C>
cudaError_t sc_dispatch_pair(const ScArgs& a, cudaStream_t stream) {
  if (!a.volume_force) {
    if (a.has_nudge || a.has_sponge) return cudaErrorInvalidValue;
    return sc_launch_pair<C, false, 0, 0>(a, stream);
  }
  return a.nudge_sigma != nullptr ? sc_launch_pair<C, true, 1, 2>(a, stream)
                                  : sc_launch_pair<C, true, 0, 2>(a, stream);
}

// One SRT step without a wall model (the plain family: nudging and the
// sponge as run-time switches, which chip_sweep.py measured no slower than
// compile-time ones); in bf16 and f16 with X even on the paired instance
// (pair_step); thermal steps go to the instances of
// stream_collide_thermal.cu, the wall models and TRT to those of
// stream_collide_wall.cu.
template <class C>
cudaError_t sc_dispatch_force(const ScArgs& a, cudaStream_t stream) {
  if (a.thermal) return sc_dispatch_thermal<C>(a, stream);
  if (a.wall || a.trt) return sc_dispatch_wall<C>(a, stream);
  if constexpr (kPairCodec<C>) {
    if (pair_step(a)) return sc_dispatch_pair<C>(a, stream);
  }
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
  return vk_launch<C>(a.fb, a.vm, a.uw, a.ue, a.us, a.un, a.ut, a.ub, a.Z, a.Y,
                      a.X, gy, gx, stream);
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

// The VK site pass alone on the encoded DDFs fb (19, Z, Y, X) in storage
// codec `storage`, in place: mask_* as luw_stream_collide's (null where a
// face carries no site), uw .. ub the FaceBC velocities, the row and lane
// faces gy / gx inside the y / x edges.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 on
// success, so 0 means one launch); no mask at all is refused.
extern "C" int luw_vk_sites(void* fb, const void* mask_uw, const void* mask_ue,
                            const void* mask_us, const void* mask_un,
                            const void* mask_ut, const void* mask_ub,
                            const void* uw, const void* ue, const void* us,
                            const void* un, const void* ut, const void* ub,
                            int Z, int Y, int X, int gy, int gx, int storage,
                            void* stream) {
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  const luw::VkMasks vm = {F(mask_uw), F(mask_ue), F(mask_us),
                           F(mask_un), F(mask_ut), F(mask_ub)};
  if (!(vm.uw || vm.ue || vm.us || vm.un || vm.ut || vm.ub))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
#define LUW_VK_ARGS \
  fb, vm, F(uw), F(ue), F(us), F(un), F(ut), F(ub), Z, Y, X, gy, gx, st
  cudaError_t err;
  switch (storage) {
    case 0: err = luw::vk_launch<luw::CodecF32>(LUW_VK_ARGS); break;
    case 1: err = luw::vk_launch<luw::CodecBF16>(LUW_VK_ARGS); break;
    case 2: err = luw::vk_launch<luw::CodecF16>(LUW_VK_ARGS); break;
    case 3: err = luw::vk_launch<luw::CodecFP16C>(LUW_VK_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef LUW_VK_ARGS
  return (int)err;
}
