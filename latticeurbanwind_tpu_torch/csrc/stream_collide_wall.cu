// The stream-collide step's wall-model and TRT instances for Hopper
// (sm_90a).
//
// Replaces: the wall-model and TRT branches of
// latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step -- ground
// specular reflection (:636-650) and Schumann stress (:678-686), the
// vertical faces' mirrors (wall_sides, :618-635) and side stress
// (:687-703), and the two-relaxation-time collision (:890-902).  The kernel
// is the tiled body of stream_collide_tiled.cuh; this unit instantiates it
// for those configurations, each in the four storage codecs, and
// stream_collide.cu's entry point dispatches here (the VK site pass then
// runs after these instances as after the others).
//
// Instances, per codec: TRT without the volume force, and with it TRT
// without a wall model, and SRT or TRT with wall_model or wall_sides -- 6,
// 24 in all, in their own nvcc process beside stream_collide.cu.  A wall
// model needs the volume force (the stress is a force).  Nudging and the
// sponge are run-time switches here (on where their pointer is set), and so
// is the side stress (on where wall_cd_sides > 0), which keeps the count at
// 6 per codec instead of 29 with those switches as template arguments.
//
// Bound on the H100: device memory, as the plain step: a mirror reads a DDF
// element in place of the bounce-back one, the partners' flags come from the
// tiled body's shared-memory ring, and TRT adds ~60 flops per cell to the
// ~300 of SRT + LES.  Measured times are in PERF.md.

#include "stream_collide_tiled.cuh"

namespace luw {

template <class C>
cudaError_t sc_dispatch_wall(const ScArgs& a, cudaStream_t stream) {
  if (!a.volume_force) {
    if (a.has_nudge || a.has_sponge || a.wall || !a.trt)
      return cudaErrorInvalidValue;
    return sc_launch_tiled<C, false, 0, 0, 0, true, false>(a, stream);
  }
  switch (a.wall * 2 + (a.trt ? 1 : 0)) {
    case 1: return sc_launch_tiled<C, true, 2, 2, 0, true, false>(a, stream);
    case 2: return sc_launch_tiled<C, true, 2, 2, 1, false, false>(a, stream);
    case 3: return sc_launch_tiled<C, true, 2, 2, 1, true, false>(a, stream);
    case 4: return sc_launch_tiled<C, true, 2, 2, 2, false, false>(a, stream);
    case 5: return sc_launch_tiled<C, true, 2, 2, 2, true, false>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t sc_dispatch_wall<CodecF32>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_wall<CodecBF16>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_wall<CodecF16>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_wall<CodecFP16C>(const ScArgs&, cudaStream_t);

}  // namespace luw
