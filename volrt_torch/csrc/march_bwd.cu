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
// What bounds it on the card: the scatter, not the gather. Every
// composited sample adds to eight voxels with atomicAdd (sixteen with the
// diffuse tap) and to two TF rows. The 16x16 pixel block that makes the
// forward's loads hit in cache makes the backward's adds collide: on a
// pose where a block's rays cover a few voxel columns, 256 threads add to
// the same few dozen addresses at every step, and the L2's atomic units
// serialise them. What the design does about it so far: dTF goes to a
// [TF_SIZE][4] accumulator in shared memory and reaches device memory as
// one atomic per touched entry per block; samples whose density cotangent
// is exactly zero (a flat stretch of the TF) skip their eight adds; the
// forward is replayed, not stored, so no per-sample state crosses device
// memory. Warp-aggregated adds and privatised tiles are later work.

#include "march_common.cuh"

namespace {

using namespace volrt;

template <bool SHADE, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__global__ void __launch_bounds__(TILE * TILE) march_bwd_kernel(
    MarchArgs a, const float* out, const float* g, GradArgs gr) {
  __shared__ float lut[TF_SIZE][4];
  __shared__ float dtf[NEED_DTF ? TF_SIZE : 1][4];
  stage_lut(a, lut);
  if (NEED_DTF) clear_dtf(dtf);
  __syncthreads();

  const int r = ray_index(a);
  if (r >= 0 && a.alive[r]) {
    const float4 gv = reinterpret_cast<const float4*>(g)[r];
    // A ray with no cotangent sends no gradient anywhere.
    if (gv.x != 0.f || gv.y != 0.f || gv.z != 0.f || gv.w != 0.f) {
      const float4 c = reinterpret_cast<const float4*>(out)[r];
      const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
      const float G = add(add(add(mul(gv.x, c.x), mul(gv.y, c.y)),
                              mul(gv.z, c.z)), mul(gv.w, c.w));
      march_replay<SHADE, NO_ERT, NEED_DTF, NEED_DVOL>(
          a, lut, dtf, gr.d_vol, load_ray(a, r), load_light(a), g4, G);
    }
  }
  if (NEED_DTF) {
    __syncthreads();
    flush_dtf(dtf, gr.d_tf);
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
