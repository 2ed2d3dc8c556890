// The whole L2 training step of the rung-5 render in one launch on Hopper:
// one thread per ray marches forward to its colour, forms its own
// cotangent of the mean-square loss, and replays the march backward.
//
// Replaces volrt/renderers/pallas/diff_v3.py:_fused_kernel in its unshaded,
// diffuse and phong modes, each with ESL and without, over an f32 volume.
// The TPU kernel keeps each tile's sample values in VMEM scratch between
// its forward and backward passes, to spare their round trip through HBM;
// here nothing per sample is kept at all, phong's gradient channels
// neither: the ray marches twice
// (march_common.cuh: march_forward, then march_replay, the device
// function march_bwd.cu launches on its own), and only the image leaves
// the kernel, from which the caller takes the loss.
//
// With scale = 2 / (H*W*4) in scal[6]:
//   g = (C - tgt) * scale * alive,   G = g . C,
// the gradient of L = sum((C - tgt)^2) * scale / 2, the image's mean
// square error (diff_v3.py:2428-2433).
//
// What bounds it on the card: as march_bwd.cu, now the two marches: the
// forward and the replay's second gather are some 3 of its 5.6 ms at
// 256^3 / 1024^2 on the benchmark pose, the warp-level scatter the rest
// (PERF.md, section 6). Against the two-launch route it saves the image's
// trip through device memory, the separate cotangent kernels and one
// launch, which is little: the one launch is kept because it is the step
// the trainer takes, not because it is much faster. In phong mode it is
// slower than the two launches (19.6 against 18.1 ms a step at 1024^2): its
// forward march runs at the replay's occupancy, one block an SM at some 158
// registers, where march_fwd runs it at 64 (PERF.md section 6).

#include "march_common.cuh"

namespace {

using namespace volrt;

template <Shade S, Esl E, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__global__ void __launch_bounds__(TILE * TILE) l2_step_kernel(
    MarchArgs a, const float* tgt, float* out, GradArgs gr, EslArgs esl) {
  __shared__ float4 lut[LUT_ROWS];
  __shared__ float dtf[NEED_DTF ? WARPS * TF_SIZE : 1][4];
  stage_padded_lut(a, lut);
  if (NEED_DTF) clear_dtf(dtf, WARPS);
  if constexpr (E == Esl::kOn) {
    __shared__ unsigned words[ESL_DIMS * ESL_DIMS];
    esl = stage_esl(esl, words);
  }
  __syncthreads();

  const int r = ray_index(a);
  bool live = false;
  Ray ray{};
  Light li{};
  float g4[4] = {0.f, 0.f, 0.f, 0.f};
  float G = 0.f;
  if (r >= 0) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    live = a.alive[r];
    if (live) {
      ray = load_ray(a, r);
      li = load_light(a);
      march_forward<S, E, NO_ERT>(a, lut, esl, ray, li, acc);
    }
    reinterpret_cast<float4*>(out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (live && (NEED_DTF || NEED_DVOL)) {
      // A dead ray seeds no cotangent (diff_v3.py:2428-2432).
      const float4 t = reinterpret_cast<const float4*>(tgt)[r];
      const float scale = a.scal[6];
      g4[0] = mul(sub(acc[0], t.x), scale);
      g4[1] = mul(sub(acc[1], t.y), scale);
      g4[2] = mul(sub(acc[2], t.z), scale);
      g4[3] = mul(sub(acc[3], t.w), scale);
      G = add(add(add(mul(g4[0], acc[0]), mul(g4[1], acc[1])),
                  mul(g4[2], acc[2])), mul(g4[3], acc[3]));
      // A ray with no cotangent sends no gradient anywhere.
      live = g4[0] != 0.f || g4[1] != 0.f || g4[2] != 0.f || g4[3] != 0.f;
    }
  }
  if (NEED_DTF || NEED_DVOL) {
    // The whole warp, lanes with no ray to replay too (march_replay).
    march_replay<S, E, NO_ERT, NEED_DTF, NEED_DVOL>(
        a, lut, esl, NEED_DTF ? warp_dtf(dtf) : dtf, gr.d_vol, ray, li, g4,
        G, live);
  }
  if (NEED_DTF) {
    __syncthreads();
    flush_dtf(dtf, WARPS, gr.d_tf);
  }
}

template <Shade S, Esl E, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
void launch(const MarchArgs& a, const float* tgt, float* out,
            const GradArgs& gr, const EslArgs& esl, cudaStream_t stream) {
  l2_step_kernel<S, E, NO_ERT, NEED_DTF, NEED_DVOL>
      <<<march_grid(a), dim3(TILE, TILE), 0, stream>>>(a, tgt, out, gr, esl);
}

template <Shade S, Esl E, bool NO_ERT>
void launch_need(const MarchArgs& a, const float* tgt, float* out,
                 const GradArgs& gr, const EslArgs& esl, bool dtf, bool dvol,
                 cudaStream_t s) {
  if (dtf) {
    dvol ? launch<S, E, NO_ERT, true, true>(a, tgt, out, gr, esl, s)
         : launch<S, E, NO_ERT, true, false>(a, tgt, out, gr, esl, s);
  } else {
    dvol ? launch<S, E, NO_ERT, false, true>(a, tgt, out, gr, esl, s)
         : launch<S, E, NO_ERT, false, false>(a, tgt, out, gr, esl, s);
  }
}

template <Shade S, Esl E>
void launch_ert(const MarchArgs& a, const float* tgt, float* out,
                const GradArgs& gr, const EslArgs& esl, bool no_ert, bool dtf,
                bool dvol, cudaStream_t s) {
  no_ert ? launch_need<S, E, true>(a, tgt, out, gr, esl, dtf, dvol, s)
         : launch_need<S, E, false>(a, tgt, out, gr, esl, dtf, dvol, s);
}

template <Shade S>
void launch_mode(const MarchArgs& a, const float* tgt, float* out,
                 const GradArgs& gr, const EslArgs& esl, bool no_ert,
                 bool dtf, bool dvol, cudaStream_t s) {
  esl.words
      ? launch_ert<S, Esl::kOn>(a, tgt, out, gr, esl, no_ert, dtf, dvol, s)
      : launch_ert<S, Esl::kOff>(a, tgt, out, gr, esl, no_ert, dtf, dvol, s);
}

}  // namespace

// Launches the step on `stream` and returns cudaGetLastError(). `tgt` is
// the target image in raster order; `out` receives the rendered image;
// `d_vol` and `d_tf` must come in zero-filled and are accumulated into.
// `esl_words` and `esl_block` are the ESL grid (null and 0 without ESL).
// Shapes, types and contiguity are checked by the Python wrapper.
extern "C" int volrt_l2_step(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, const void* tgt, void* out,
    void* d_vol, void* d_tf, int n, int width, float step, int max_steps,
    int shade, int no_ert, int need_dtf, int need_dvol, const void* esl_words,
    int esl_block, void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                      tf, scal, n, width, step, max_steps);
  const GradArgs gr{static_cast<float*>(d_vol), static_cast<float*>(d_tf)};
  const EslArgs esl = make_esl_args(esl_words, esl_block);
  const float* ct = static_cast<const float*>(tgt);
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dtf = need_dtf != 0, dvol = need_dvol != 0;
  if (shade == 2) {
    launch_mode<Shade::kPhong>(a, ct, dst, gr, esl, no_ert, dtf, dvol, s);
  } else if (shade) {
    launch_mode<Shade::kDiffuse>(a, ct, dst, gr, esl, no_ert, dtf, dvol, s);
  } else {
    launch_mode<Shade::kNone>(a, ct, dst, gr, esl, no_ert, dtf, dvol, s);
  }
  return static_cast<int>(cudaGetLastError());
}
