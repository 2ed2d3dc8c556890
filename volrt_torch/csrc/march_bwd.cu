// Backward march of the rung-5 render on Hopper: one thread per ray.
//
// Replaces volrt/renderers/pallas/diff_v3.py:_bwd_kernel in its unshaded
// and diffuse modes over an f32 volume (the phong chain, the slab mode's
// acc0 cotangent, ESL and saved samples are not ported yet). The TPU kernel
// batches a band group's cotangent chain, scatters dTF and dVol with
// one-hot matrix products into a VMEM accumulator and flushes that to HBM
// in planned flush passes; here each ray replays its own march
// (march_common.cuh:march_replay) and adds its gradient straight to where
// it belongs, so none of the flush passes, flush boxes or lost-row counters
// exist.
//
// What bounds it on the card. Every composited sample adds to two TF rows
// and, where the TF has a slope, to eight voxels (sixteen with the diffuse
// tap). The 16x16 pixel block that makes the forward's loads hit in cache
// makes those adds collide: a warp's lanes sample neighbouring pixels at
// the same step, so they land on a few TF rows and a few voxels, and adds
// to one address serialise (a float add to shared memory is a
// compare-and-swap loop on this card). The scatter is march_common.cuh's
// kWarp: the lanes that add to one TF row or one trilinear cell sum among
// themselves first (__match_any_sync and a shuffle tree) and one lane adds,
// dTF with plain adds into the warp's own copy of the block's accumulator
// (one atomic per touched entry per block at the end), dVol with global
// atomics. For that the warp's lanes replay in one loop until its last ray
// ends, so every collective takes the full warp. Samples whose density
// cotangent is exactly zero (a flat stretch of the TF) add nothing to dVol;
// the forward is replayed, not stored. What is left on the benchmark pose
// is the replay's gather, about as long as the forward march, and the
// scatter's shuffles (PERF.md, section 6).

#include "march_common.cuh"

namespace {

using namespace volrt;

template <bool SHADE, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__global__ void __launch_bounds__(TILE * TILE) march_bwd_kernel(
    MarchArgs a, const float* out, const float* g, GradArgs gr) {
  __shared__ float4 lut[LUT_ROWS];
  __shared__ float dtf[NEED_DTF ? WARPS * TF_SIZE : 1][4];
  stage_padded_lut(a, lut);
  if (NEED_DTF) clear_dtf(dtf, WARPS);
  __syncthreads();

  Ray ray{};
  Light li{};
  float g4[4] = {0.f, 0.f, 0.f, 0.f};
  float G = 0.f;
  const bool live = start_replay(a, out, g, ray_index(a), ray, li, g4, G);
  // The whole warp, lanes with no ray to replay too (march_replay).
  march_replay<SHADE, NO_ERT, NEED_DTF, NEED_DVOL>(
      a, lut, NEED_DTF ? warp_dtf(dtf) : dtf, gr.d_vol, ray, li, g4, G, live);
  if (NEED_DTF) {
    __syncthreads();
    flush_dtf(dtf, WARPS, gr.d_tf);
  }
}

template <bool SHADE, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
void launch(const MarchArgs& a, const float* out, const float* g,
            const GradArgs& gr, cudaStream_t stream) {
  march_bwd_kernel<SHADE, NO_ERT, NEED_DTF, NEED_DVOL>
      <<<march_grid(a), dim3(TILE, TILE), 0, stream>>>(a, out, g, gr);
}

template <bool SHADE, bool NO_ERT>
void launch_need(const MarchArgs& a, const float* out, const float* g,
                 const GradArgs& gr, bool dtf, bool dvol, cudaStream_t s) {
  if (dtf) {
    dvol ? launch<SHADE, NO_ERT, true, true>(a, out, g, gr, s)
         : launch<SHADE, NO_ERT, true, false>(a, out, g, gr, s);
  } else if (dvol) {
    launch<SHADE, NO_ERT, false, true>(a, out, g, gr, s);
  }
}

}  // namespace

// Launches the backward march on `stream` and returns cudaGetLastError().
// `out` is the forward's image, `g` its cotangent; `d_vol` and `d_tf` must
// come in zero-filled and are accumulated into. Shapes, types and
// contiguity are checked by the Python wrapper.
extern "C" int volrt_march_bwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, const void* out, const void* g,
    void* d_vol, void* d_tf, int n, int width, float step, int max_steps,
    int shade, int no_ert, int need_dtf, int need_dvol, void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                      tf, scal, n, width, step, max_steps);
  const GradArgs gr{static_cast<float*>(d_vol), static_cast<float*>(d_tf)};
  const float* co = static_cast<const float*>(out);
  const float* cg = static_cast<const float*>(g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dtf = need_dtf != 0, dvol = need_dvol != 0;
  if (shade) {
    no_ert ? launch_need<true, true>(a, co, cg, gr, dtf, dvol, s)
           : launch_need<true, false>(a, co, cg, gr, dtf, dvol, s);
  } else {
    no_ert ? launch_need<false, true>(a, co, cg, gr, dtf, dvol, s)
           : launch_need<false, false>(a, co, cg, gr, dtf, dvol, s);
  }
  return static_cast<int>(cudaGetLastError());
}
