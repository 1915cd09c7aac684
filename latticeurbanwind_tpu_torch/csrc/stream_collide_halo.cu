// The stream-collide step's halo-mode instances for Hopper (sm_90a): K8.
//
// Replaces: the halo_mode branch of
// latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step (:409,
// :1032-1042, :1205-1241), the per-shard step that
// latticeurbanwind_tpu/parallel/halo.py::make_sharded_pallas_runner runs on
// every device of a split domain.  The kernel is the tiled body of
// stream_collide_tiled.cuh with kHalo set: a z pull whose source leaves the
// slab reads the plane the neighbouring slab supplies (HaloArgs, lattice.cuh)
// -- the flag ring fetches the halo planes' flags (the bounce-back test, the
// wall models' mirror partners and the Schumann stress's flag below), the
// pulls read their channels, the mirrors' partners and the thermal +-z pulls read them through the element
// accessor -- while y and x still wrap inside the slab's ghost-extended
// plane, whose ghost outputs the runner's next exchange overwrites.  This
// unit instantiates it, each configuration in the four storage codecs, each
// on its family's compile-time shape, and stream_collide.cu's
// entry point dispatches here when halo planes are given (the VK site pass
// then runs with the slab's ghost offsets).
//
// Instances, per codec: without the volume force SRT and TRT; with it SRT or
// TRT, each without a wall model, with wall_model and with wall_sides -- 8,
// 32 in all; the thermal ones (6 per codec, 24) are the unit
// stream_collide_halo_thermal.cu, so the two compile in parallel.  Nudging,
// the sponge and the side stress are run-time switches, as in
// stream_collide_wall.cu.
//
// Bound on the H100: device memory, as the single-device step; the halo
// planes add 2 * 5 (thermal 2 * 6) * sizeof(storage) bytes per plane cell
// of the slab, read once by the cells of its first and last plane.
//
// Design: the same per-cell arithmetic as on one device, so a slab's cell
// runs the same arithmetic on the same inputs and a split run's stored DDFs
// equal the single-device run's bit for bit.  A halo plane can be a view
// into the neighbouring slab's own DDF buffer (channel stride = its cell
// count) when both slabs live on one device: the runner then copies no z
// plane at all.

#include "stream_collide_tiled.cuh"

namespace luw {

template <class C>
cudaError_t sc_dispatch_halo(const ScArgs& a, cudaStream_t stream) {
  const HaloArgs& h = a.halo;
  if (h.fp == nullptr || h.fm == nullptr || h.flb == nullptr ||
      h.fla == nullptr || (a.thermal && (h.gp == nullptr || h.gm == nullptr)))
    return cudaErrorInvalidValue;
  if (a.thermal) return sc_dispatch_halo_thermal<C>(a, stream);
  if (!a.volume_force) {
    if (a.has_nudge || a.has_sponge || a.wall) return cudaErrorInvalidValue;
    return a.trt
               ? sc_launch_tiled<C, false, 0, 0, 0, true, false, true>(a, stream)
               : sc_launch_tiled<C, false, 0, 0, 0, false, false, true>(a,
                                                                       stream);
  }
  switch (a.wall * 2 + (a.trt ? 1 : 0)) {
    case 0: return sc_launch_tiled<C, true, 2, 2, 0, false, false, true>(a, stream);
    case 1: return sc_launch_tiled<C, true, 2, 2, 0, true, false, true>(a, stream);
    case 2: return sc_launch_tiled<C, true, 2, 2, 1, false, false, true>(a, stream);
    case 3: return sc_launch_tiled<C, true, 2, 2, 1, true, false, true>(a, stream);
    case 4: return sc_launch_tiled<C, true, 2, 2, 2, false, false, true>(a, stream);
    case 5: return sc_launch_tiled<C, true, 2, 2, 2, true, false, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t sc_dispatch_halo<CodecF32>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_halo<CodecBF16>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_halo<CodecF16>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_halo<CodecFP16C>(const ScArgs&, cudaStream_t);

}  // namespace luw
