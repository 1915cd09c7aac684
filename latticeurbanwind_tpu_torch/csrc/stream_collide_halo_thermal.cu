// The stream-collide step's thermal halo-mode instances for Hopper (sm_90a):
// K8 with the D3Q7 sub-lattice.
//
// Replaces: the halo_mode branch of
// latticeurbanwind_tpu/ops/stream_collide.py::make_pallas_step (:409,
// :1032-1042, :1222-1241) for a thermal configuration (its gp / gm halos).
// The kernel (the tiled body with kHalo and kThermal set, on the thermal
// families' shapes), its bound and its design are those of
// stream_collide_halo.cu; this unit holds the thermal instances (SRT or TRT,
// each without a wall model, with wall_model and with wall_sides: 6 per
// codec, 24 in all), so that they compile beside the non-thermal ones in
// their own nvcc process.

#include "stream_collide_tiled.cuh"

namespace luw {

template <class C>
cudaError_t sc_dispatch_halo_thermal(const ScArgs& a, cudaStream_t stream) {
  if (!a.volume_force || a.th.ga == nullptr || a.th.gb == nullptr ||
      (a.has_sponge && a.th.tt == nullptr))
    return cudaErrorInvalidValue;
  switch (a.wall * 2 + (a.trt ? 1 : 0)) {
    case 0: return sc_launch_tiled<C, true, 2, 2, 0, false, true, true>(a, stream);
    case 1: return sc_launch_tiled<C, true, 2, 2, 0, true, true, true>(a, stream);
    case 2: return sc_launch_tiled<C, true, 2, 2, 1, false, true, true>(a, stream);
    case 3: return sc_launch_tiled<C, true, 2, 2, 1, true, true, true>(a, stream);
    case 4: return sc_launch_tiled<C, true, 2, 2, 2, false, true, true>(a, stream);
    case 5: return sc_launch_tiled<C, true, 2, 2, 2, true, true, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t sc_dispatch_halo_thermal<CodecF32>(const ScArgs&,
                                                        cudaStream_t);
template cudaError_t sc_dispatch_halo_thermal<CodecBF16>(const ScArgs&,
                                                         cudaStream_t);
template cudaError_t sc_dispatch_halo_thermal<CodecF16>(const ScArgs&,
                                                        cudaStream_t);
template cudaError_t sc_dispatch_halo_thermal<CodecFP16C>(const ScArgs&,
                                                          cudaStream_t);

}  // namespace luw
