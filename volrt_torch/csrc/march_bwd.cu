// Backward march of the rung-5 render on Hopper: one thread per ray.
//
// Replaces volrt/renderers/pallas/diff_v3.py:_bwd_kernel in its unshaded,
// diffuse and phong modes, each with ESL and without, and in its slab mode
// (unshaded and diffuse, with ESL and without), over an f32 volume or, in
// its fast mode, a bf16 one (saved samples are not ported); with ESL the
// replay skips the forward's samples. The TPU kernel
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
//
// In phong mode the replay takes the forward's shading again, with its six
// gradient taps, and runs the phong chain (march_common.cuh:phong_chain);
// a gated sample then scatters into seven cells, its own and the
// gradient's six, each grouped across the warp by a key of its own. That
// variant holds some 155 registers, so one 256-thread block fills an SM
// (8 warps against 32 unshaded) and the scatter's latency shows: 14 ms
// against 3.7 unshaded at 1024^2 (PERF.md section 6).
//
// In slab mode (Slab::kOn, march_fwd.cu) the replay starts from the seed
// acc0, the opacity in front of the slab, and the suffix total leaves the
// seed's share out: G = g . out - g.a acc0 (diff_v3.py:1503-1506, 2292-2295).
// The output is out = (0, 0, 0, acc0) + (1 - acc0) U, U the unseeded
// march, so the seed's cotangent is dacc0 = g.a - g . U = g.a - P / (1 -
// acc0) with P the replay's prefix of contributions (diff_v3.py:2358-2366),
// the denominator floored at 1e-6 as volrt floors it. Every ray of the
// image gets its dacc0, a ray that does not replay (dead, no cotangent, or
// its seed over the ERT threshold) g.a.
//
// In the fast mode (Voxel::kBf16, volrt's fast=True) the replay samples a
// bf16 volume as the fast forward does (march_fwd.cu), and the scatter
// keeps its f32 weights (volrt's _expand_taps(..., f32), diff_v3.py:
// 2138-2220) into the f32 d_vol: the density's gradient is not rounded.

#include "march_common.cuh"

namespace {

using namespace volrt;

template <Shade S, Esl E, Slab SL, Voxel X, bool NO_ERT, bool NEED_DTF,
          bool NEED_DVOL>
__global__ void __launch_bounds__(TILE * TILE) march_bwd_kernel(
    MarchArgs a, const float* out, const float* g, GradArgs gr, EslArgs esl,
    SlabArgs sl) {
  __shared__ float4 lut[LUT_ROWS];
  __shared__ float dtf[NEED_DTF ? WARPS * TF_SIZE : 1][4];
  stage_padded_lut(a, lut);
  if (NEED_DTF) clear_dtf(dtf, WARPS);
  if constexpr (E == Esl::kOn) {
    __shared__ unsigned words[ESL_DIMS * ESL_DIMS];
    esl = stage_esl(esl, words);
  }
  __syncthreads();

  Ray ray{};
  Light li{};
  float g4[4] = {0.f, 0.f, 0.f, 0.f};
  float G = 0.f;
  using V = typename VoxelOf<X>::T;
  if constexpr (SL == Slab::kOn) {
    const int r = ray_index(a);
    const bool live = start_replay(a, out, g, r, ray, li, g4, G);
    const float acc0 = r < 0 ? 0.f : sl.acc0[r];
    if (live) G = sub(G, mul(g4[3], acc0));
    // The whole warp, lanes with no ray to replay too (march_replay_slab).
    const float P = march_replay_slab<S, E, NO_ERT, NEED_DTF, NEED_DVOL, V>(
        a, lut, esl, load_slab(a, sl), NEED_DTF ? warp_dtf(dtf) : dtf,
        gr.d_vol, ray, li, g4, G, live, acc0);
    if (r >= 0) {
      sl.dacc0[r] = sub(g[4 * r + 3],
                        __fdiv_rn(P, fmaxf(sub(1.f, acc0), 1e-6f)));
    }
  } else {
    const bool live = start_replay(a, out, g, ray_index(a), ray, li, g4, G);
    // The whole warp, lanes with no ray to replay too (march_replay).
    march_replay<S, E, NO_ERT, NEED_DTF, NEED_DVOL, V>(
        a, lut, esl, NEED_DTF ? warp_dtf(dtf) : dtf, gr.d_vol, ray, li, g4, G,
        live);
  }
  if (NEED_DTF) {
    __syncthreads();
    flush_dtf(dtf, WARPS, gr.d_tf);
  }
}

template <Shade S, Esl E, Slab SL, Voxel X, bool NO_ERT, bool NEED_DTF,
          bool NEED_DVOL>
void launch(const MarchArgs& a, const float* out, const float* g,
            const GradArgs& gr, const EslArgs& esl, const SlabArgs& sl,
            cudaStream_t stream) {
  march_bwd_kernel<S, E, SL, X, NO_ERT, NEED_DTF, NEED_DVOL>
      <<<march_grid(a), dim3(TILE, TILE), 0, stream>>>(a, out, g, gr, esl,
                                                       sl);
}

// The slab mode launches with no leaf's scatter too: dacc0 is its own
// output.
template <Shade S, Esl E, Slab SL, Voxel X, bool NO_ERT>
void launch_need(const MarchArgs& a, const float* out, const float* g,
                 const GradArgs& gr, const EslArgs& esl, const SlabArgs& sl,
                 bool dtf, bool dvol, cudaStream_t s) {
  if (dtf) {
    dvol ? launch<S, E, SL, X, NO_ERT, true, true>(a, out, g, gr, esl, sl, s)
         : launch<S, E, SL, X, NO_ERT, true, false>(a, out, g, gr, esl, sl,
                                                    s);
  } else if (dvol) {
    launch<S, E, SL, X, NO_ERT, false, true>(a, out, g, gr, esl, sl, s);
  } else if constexpr (SL == Slab::kOn) {
    launch<S, E, SL, X, NO_ERT, false, false>(a, out, g, gr, esl, sl, s);
  }
}

template <Shade S, Esl E, Slab SL, Voxel X>
void launch_ert(const MarchArgs& a, const float* out, const float* g,
                const GradArgs& gr, const EslArgs& esl, const SlabArgs& sl,
                bool no_ert, bool dtf, bool dvol, cudaStream_t s) {
  no_ert ? launch_need<S, E, SL, X, true>(a, out, g, gr, esl, sl, dtf, dvol,
                                          s)
         : launch_need<S, E, SL, X, false>(a, out, g, gr, esl, sl, dtf, dvol,
                                           s);
}

template <Shade S, Slab SL, Voxel X>
void launch_esl(const MarchArgs& a, const float* out, const float* g,
                const GradArgs& gr, const EslArgs& esl, const SlabArgs& sl,
                bool no_ert, bool dtf, bool dvol, cudaStream_t s) {
  esl.words ? launch_ert<S, Esl::kOn, SL, X>(a, out, g, gr, esl, sl, no_ert,
                                             dtf, dvol, s)
            : launch_ert<S, Esl::kOff, SL, X>(a, out, g, gr, esl, sl, no_ert,
                                              dtf, dvol, s);
}

template <Voxel X>
int launch_mode(const MarchArgs& a, const float* co, const float* cg,
                const GradArgs& gr, const EslArgs& esl, const SlabArgs& sl,
                int shade, bool no_ert, bool dtf, bool dvol, cudaStream_t s) {
  if (sl.acc0) {
    if (shade == 2 || !sl.dacc0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    shade ? launch_esl<Shade::kDiffuse, Slab::kOn, X>(a, co, cg, gr, esl, sl,
                                                      no_ert, dtf, dvol, s)
          : launch_esl<Shade::kNone, Slab::kOn, X>(a, co, cg, gr, esl, sl,
                                                   no_ert, dtf, dvol, s);
  } else if (shade == 2) {
    launch_esl<Shade::kPhong, Slab::kOff, X>(a, co, cg, gr, esl, sl, no_ert,
                                             dtf, dvol, s);
  } else if (shade) {
    launch_esl<Shade::kDiffuse, Slab::kOff, X>(a, co, cg, gr, esl, sl, no_ert,
                                               dtf, dvol, s);
  } else {
    launch_esl<Shade::kNone, Slab::kOff, X>(a, co, cg, gr, esl, sl, no_ert,
                                            dtf, dvol, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward march on `stream` and returns cudaGetLastError().
// `out` is the forward's image, `g` its cotangent; `d_vol` and `d_tf` must
// come in zero-filled and are accumulated into. `esl_words` and
// `esl_block` are the forward's ESL grid (null and 0 without ESL). `acc0`,
// `dacc0` (f32[N] each) and `full_d` are the slab mode's (march_fwd.cu),
// z_off in scal[5]; dacc0 is written for every ray. Null ones march the
// volume whole. The slab mode has no phong (volrt, diff_v3.py:2920).
// `voxel` is the volume's type: 0 f32, 1 bf16 (the fast mode); d_vol is
// f32 in either. Shapes, types and contiguity are checked by the Python
// wrapper.
extern "C" int volrt_march_bwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, const void* out, const void* g,
    void* d_vol, void* d_tf, int n, int width, float step, int max_steps,
    int shade, int no_ert, int need_dtf, int need_dvol, const void* esl_words,
    int esl_block, const void* acc0, void* dacc0, int full_d, int voxel,
    void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                      tf, scal, n, width, step, max_steps);
  const GradArgs gr{static_cast<float*>(d_vol), static_cast<float*>(d_tf)};
  const EslArgs esl = make_esl_args(esl_words, esl_block);
  const SlabArgs sl = make_slab_args(acc0, dacc0, full_d);
  const float* co = static_cast<const float*>(out);
  const float* cg = static_cast<const float*>(g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dtf = need_dtf != 0, dvol = need_dvol != 0;
  if (voxel == 1) {
    return launch_mode<Voxel::kBf16>(a, co, cg, gr, esl, sl, shade,
                                     no_ert != 0, dtf, dvol, s);
  }
  if (voxel != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mode<Voxel::kF32>(a, co, cg, gr, esl, sl, shade, no_ert != 0,
                                  dtf, dvol, s);
}
