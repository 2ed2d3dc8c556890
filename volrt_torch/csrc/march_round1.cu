// The round-1 differentiable march on Hopper, forward and backward: one
// thread per ray, 16x16 pixel blocks, as march_fwd.cu and march_bwd.cu.
//
// Four entry points, two bodies:
//
// - volrt_diff_tri_fwd and volrt_diff_tri_bwd replace
//   volrt/renderers/pallas/diff_tri.py:_fwd_kernel and _bwd_kernel, the
//   pair whose volume and gradient stay resident in the TPU's VMEM
//   (W <= 128 there);
// - volrt_diff_blocked_fwd and volrt_diff_blocked_bwd replace
//   volrt/renderers/pallas/diff_blocked.py:_fwd_kernel and _bwd_kernel, the
//   pair for a volume of any size in HBM.
//
// On the TPU the two pairs differ in where the volume and its gradient
// live; the function they compute is one. Here every ray loads its own taps
// from device memory and adds its gradient where it belongs, so each pair
// launches the same body. Not carried over: the (wz, wy) windows, the
// one-hot tap and TF matrices and their matrix products, the lane gather,
// band marching and each ray's band offset, the resident brick and its DMA,
// the (AZ, AY, AXB) accumulator with its flushes and the aliased dVol
// input, and the padding of density and TF.
//
// The math is an unshaded march over an f32 density in [0, 1] (no division,
// no light tap). What sets it apart from march_fwd.cu and march_bwd.cu:
//
// - the lattice accumulates: k starts at the ray's k0 and gains one rounded
//   `+ step` per sample; the first sample of a live ray is always taken and
//   the ray ends, after compositing, when acc.a > threshold or the next k
//   exceeds kfar (diff_tri.py:177-180), as march_ladder.cu marches. The
//   backward replays the same loop, so it crosses the ERT latch and the
//   ray's end on the forward's sample;
// - the density slope is (tf[hi] - tf[lo]) * TF_SIZE of the clamped rows
//   with no in-range flag (diff_tri.py:281-286): zero only where the rows
//   coincide (march_common.cuh:replay_sample, IN_RANGE = false).
//
// The cotangent chain is replay_sample's: T = 1 - acc.a, contrib = (g.c) T,
// S_next = G - (P + contrib) with G = g . out from the saved forward, the
// division by 1 - c.a guarded at 1e-6. A ray that is not alive, or whose
// cotangent is zero, sends nothing.
//
// What bounds them on the card (bench/step_ab.py, PERF.md section 6). The
// forward is the ladder's march over a density: instruction issue, then load
// latency, not device memory and not the FP32 rate; its design is the
// ladder's (march_common.cuh: classify with Units::kDensity, no division;
// march_accumulating, one body with march_ladder_kernel). The backward as
// march_bwd.cu, the replay's march and its scatter: every composited sample
// adds to two TF rows and, where the TF has a slope, to eight voxels, and a
// warp's lanes land on few of them. The backward takes march_bwd.cu's
// design: march_common.cuh's warp-level scatter (lanes that add to one TF
// row or one trilinear cell sum among themselves and one lane adds; dTF with
// plain adds into the warp's own copy of the block's accumulator, one atomic
// per touched entry per block at the end; dVol with global atomics), for
// which the warp's lanes replay in one loop until its last ray ends
// (march_replay_round1, on this lattice), lanes with no ray too. What the
// warp cannot sum is the adds of other warps and blocks to one voxel: on a
// small volume under a large viewport (diff_tri's) many rays share a voxel,
// and the dVol atomics collide across warps. Samples whose density cotangent
// is exactly zero add nothing to dVol; the forward is replayed, not stored.
// Voxel offsets are 32-bit in round1_fwd_kernel and round1_bwd_kernel, so
// diff_tri's entry points take a volume under 2^31 voxels (the wrapper
// refuses more). diff_blocked's take one of any size: given `wide` (2^31
// voxels or more) they launch round1_fwd_wide_kernel and
// round1_bwd_wide_kernel, the same bodies with 64-bit offsets
// (march_common.cuh:Unsigned), the dVol scatter's addresses and cell keys
// included.
//
// Every multiply and add of the forward chain is rounded on its own
// (march_common.cuh), in the plain torch versions' order
// (volrt_torch/renderers/cuda/round1.py), so that kernel and plain version
// agree to the bit in the image and cross the ERT latch on the same sample.

#include "march_common.cuh"

namespace {

using namespace volrt;

// The ladder's march (march_ladder.cu) over a density in [0, 1],
// unshaded: one body, march_common.cuh:march_accumulating.
template <bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE)
    round1_fwd_kernel(MarchArgs a, float* out) {
  __shared__ float4 lut[LUT_ROWS];
  stage_padded_lut(a, lut);
  __syncthreads();
  march_accumulating<float, Units::kDensity, false, false, NO_ERT>(
      a, a.vol, lut, out);
}

template <bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__global__ void __launch_bounds__(TILE * TILE) round1_bwd_kernel(
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
  // The whole warp, lanes with no ray to replay too (march_replay_round1).
  march_replay_round1<NO_ERT, NEED_DTF, NEED_DVOL>(
      a, lut, NEED_DTF ? warp_dtf(dtf) : dtf, gr.d_vol, ray, li, g4, G, live);
  if (NEED_DTF) {
    __syncthreads();
    flush_dtf(dtf, WARPS, gr.d_tf);
  }
}

// The same two on a volume of 2^31 voxels or more: 64-bit voxel offsets.
template <bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE)
    round1_fwd_wide_kernel(MarchArgs a, float* out) {
  __shared__ float4 lut[LUT_ROWS];
  stage_padded_lut(a, lut);
  __syncthreads();
  march_accumulating<float, Units::kDensity, false, false, NO_ERT,
                     long long>(a, a.vol, lut, out);
}

template <bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__global__ void __launch_bounds__(TILE * TILE) round1_bwd_wide_kernel(
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
  march_replay_round1<NO_ERT, NEED_DTF, NEED_DVOL, long long>(
      a, lut, NEED_DTF ? warp_dtf(dtf) : dtf, gr.d_vol, ray, li, g4, G, live);
  if (NEED_DTF) {
    __syncthreads();
    flush_dtf(dtf, WARPS, gr.d_tf);
  }
}

int launch_fwd(const MarchArgs& a, void* out, int no_ert, int wide,
               void* stream) {
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = march_grid(a), block(TILE, TILE);
  if (wide) {
    if (no_ert) round1_fwd_wide_kernel<true><<<grid, block, 0, s>>>(a, dst);
    else round1_fwd_wide_kernel<false><<<grid, block, 0, s>>>(a, dst);
  } else {
    if (no_ert) round1_fwd_kernel<true><<<grid, block, 0, s>>>(a, dst);
    else round1_fwd_kernel<false><<<grid, block, 0, s>>>(a, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
void launch_bwd_variant(const MarchArgs& a, const float* out, const float* g,
                        const GradArgs& gr, bool wide, cudaStream_t s) {
  const dim3 grid = march_grid(a), block(TILE, TILE);
  if (wide) {
    round1_bwd_wide_kernel<NO_ERT, NEED_DTF, NEED_DVOL>
        <<<grid, block, 0, s>>>(a, out, g, gr);
  } else {
    round1_bwd_kernel<NO_ERT, NEED_DTF, NEED_DVOL>
        <<<grid, block, 0, s>>>(a, out, g, gr);
  }
}

template <bool NO_ERT>
void launch_bwd_need(const MarchArgs& a, const float* out, const float* g,
                     const GradArgs& gr, bool dtf, bool dvol, bool wide,
                     cudaStream_t s) {
  if (dtf) {
    dvol ? launch_bwd_variant<NO_ERT, true, true>(a, out, g, gr, wide, s)
         : launch_bwd_variant<NO_ERT, true, false>(a, out, g, gr, wide, s);
  } else if (dvol) {
    launch_bwd_variant<NO_ERT, false, true>(a, out, g, gr, wide, s);
  }
}

int launch_bwd(const MarchArgs& a, const void* out, const void* g,
               void* d_vol, void* d_tf, int no_ert, int need_dtf,
               int need_dvol, int wide, void* stream) {
  const GradArgs gr{static_cast<float*>(d_vol), static_cast<float*>(d_tf)};
  const float* co = static_cast<const float*>(out);
  const float* cg = static_cast<const float*>(g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dtf = need_dtf != 0, dvol = need_dvol != 0, w = wide != 0;
  no_ert ? launch_bwd_need<true>(a, co, cg, gr, dtf, dvol, w, s)
         : launch_bwd_need<false>(a, co, cg, gr, dtf, dvol, w, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All four launch on `stream` and return cudaGetLastError() as an int.
// Shapes, types and contiguity are checked by the Python wrappers. `vol` is
// the f32[D, H, W] density in [0, 1]. For the backwards, `out` is the
// forward's image and `g` its cotangent; `d_vol` and `d_tf` must come in
// zero-filled and are accumulated into. diff_blocked's `wide` picks 64-bit
// voxel offsets (a volume of 2^31 voxels or more).
extern "C" int volrt_diff_tri_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int no_ert, void* stream) {
  return launch_fwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, no_ert, 0, stream);
}

extern "C" int volrt_diff_blocked_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int no_ert, int wide, void* stream) {
  return launch_fwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, no_ert, wide, stream);
}

extern "C" int volrt_diff_tri_bwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, const void* out, const void* g,
    void* d_vol, void* d_tf, int n, int width, float step, int max_steps,
    int no_ert, int need_dtf, int need_dvol, void* stream) {
  return launch_bwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, g, d_vol, d_tf, no_ert, need_dtf, need_dvol, 0,
                    stream);
}

extern "C" int volrt_diff_blocked_bwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, const void* out, const void* g,
    void* d_vol, void* d_tf, int n, int width, float step, int max_steps,
    int no_ert, int need_dtf, int need_dvol, int wide, void* stream) {
  return launch_bwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, g, d_vol, d_tf, no_ert, need_dtf, need_dvol, wide,
                    stream);
}
