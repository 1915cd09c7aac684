// The stream-collide step's thermal instances for Hopper (sm_90a).
//
// Replaces: the thermal branch of
// latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step -- the D3Q7
// temperature sub-lattice with fixed-temperature (TYPE_T) cells, the top
// sponge on T and the Boussinesq coupling into the force (:732-807, outputs
// :909-913).  The kernel is the tiled body of stream_collide_tiled.cuh with
// kThermal set, the per-cell D3Q7 work the pull and relax halves of
// thermal.cuh; this unit instantiates it, each configuration in the four
// storage codecs, and stream_collide.cu's entry point dispatches here (the VK
// site pass then runs after these instances as after the others; it does not
// touch g).
//
// Instances, per codec: SRT or TRT, each without a wall model, with
// wall_model and with wall_sides -- 6, 24 in all, in their own nvcc process.
// A thermal step always has the volume force (buoyancy is a force); nudging,
// the sponge and the side stress are run-time switches as in
// stream_collide_wall.cu.  One fused kernel: T enters the force of the f
// collision, so a second kernel would have to pull the g populations again
// or pass T through device memory.
//
// Bound on the H100: device memory, 2 * (19 + 7) * sizeof(storage) + 1 bytes
// per cell update (105 B in the 2-byte storages, 209 B in f32) plus 5 B of
// nudge fields.  What the tiled body does about the rest is in its header;
// measured times are in PERF.md.

#include "stream_collide_tiled.cuh"

namespace luw {

template <class C>
cudaError_t sc_dispatch_thermal(const ScArgs& a, cudaStream_t stream) {
  if (!a.volume_force || a.th.ga == nullptr || a.th.gb == nullptr ||
      (a.has_sponge && a.th.tt == nullptr))
    return cudaErrorInvalidValue;
  switch (a.wall * 2 + (a.trt ? 1 : 0)) {
    case 0: return sc_launch_tiled<C, true, 2, 2, 0, false, true>(a, stream);
    case 1: return sc_launch_tiled<C, true, 2, 2, 0, true, true>(a, stream);
    case 2: return sc_launch_tiled<C, true, 2, 2, 1, false, true>(a, stream);
    case 3: return sc_launch_tiled<C, true, 2, 2, 1, true, true>(a, stream);
    case 4: return sc_launch_tiled<C, true, 2, 2, 2, false, true>(a, stream);
    case 5: return sc_launch_tiled<C, true, 2, 2, 2, true, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t sc_dispatch_thermal<CodecF32>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_thermal<CodecBF16>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_thermal<CodecF16>(const ScArgs&, cudaStream_t);
template cudaError_t sc_dispatch_thermal<CodecFP16C>(const ScArgs&, cudaStream_t);

}  // namespace luw
