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
// What bounds them on the card: the forward as march_ladder.cu, gather
// latency and L1/L2 traffic (eight dependent loads and some 80 f32
// operations per sample); the backward as march_bwd.cu, its scatter: eight
// global atomicAdds per sample into dVol, which collide the more the fewer
// voxel columns a block's rays cross (a small volume under a large
// viewport), and eight shared-memory adds into the block's dTF rows. What
// the design does about it so far is march_common.cuh's kLane scatter: dTF
// per block in shared memory, one global atomic per touched entry per
// block; samples whose density cotangent is exactly zero skip their eight
// adds; the forward is replayed, not stored. The warp-level kWarp scatter
// of march_bwd.cu is not taken here yet. Voxel offsets are 32-bit, so a
// volume holds under 2^31 voxels (the wrapper refuses more).
//
// Every multiply and add of the forward chain is rounded on its own
// (march_common.cuh), in the plain torch versions' order
// (volrt_torch/renderers/cuda/round1.py), so that kernel and plain version
// agree to the bit in the image and cross the ERT latch on the same sample.

#include "march_common.cuh"

namespace {

using namespace volrt;

template <bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE)
    round1_fwd_kernel(MarchArgs a, float* out) {
  __shared__ float lut[TF_SIZE][4];
  stage_lut(a, lut);
  __syncthreads();

  const int r = ray_index(a);
  if (r < 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.alive[r]) {
    const Ray ray = load_ray(a, r);
    const Light li = load_light(a);
    Sample q;
    float k = ray.ks;
    for (int i = 0; i < a.max_steps; ++i) {
      sample_at<false>(a, lut, ray, li, k, q);
      composite(acc, q.c);
      k = add(k, a.step);
      if ((!NO_ERT && acc[3] > li.thr) || !(k <= ray.ke)) break;
    }
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__global__ void __launch_bounds__(TILE * TILE) round1_bwd_kernel(
    MarchArgs a, const float* out, const float* g, GradArgs gr) {
  __shared__ float lut[TF_SIZE][4];
  __shared__ float dtf[NEED_DTF ? TF_SIZE : 1][4];
  stage_lut(a, lut);
  if (NEED_DTF) clear_dtf(dtf, 1);
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
      const Ray ray = load_ray(a, r);
      const Light li = load_light(a);
      Sample q;
      Chain ch;
      float k = ray.ks;
      for (int i = 0; i < a.max_steps; ++i) {
        sample_at<false>(a, lut, ray, li, k, q);
        replay_sample<false, NEED_DTF, NEED_DVOL, false, Scatter::kLane>(
            lut, dtf, gr.d_vol, li, g4, G, q, ch);
        k = add(k, a.step);
        if ((!NO_ERT && ch.acc_a > li.thr) || !(k <= ray.ke)) break;
      }
    }
  }
  if (NEED_DTF) {
    __syncthreads();
    flush_dtf(dtf, 1, gr.d_tf);
  }
}

int launch_fwd(const MarchArgs& a, void* out, int no_ert, void* stream) {
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = march_grid(a), block(TILE, TILE);
  if (no_ert) round1_fwd_kernel<true><<<grid, block, 0, s>>>(a, dst);
  else round1_fwd_kernel<false><<<grid, block, 0, s>>>(a, dst);
  return static_cast<int>(cudaGetLastError());
}

template <bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
void launch_bwd_variant(const MarchArgs& a, const float* out, const float* g,
                        const GradArgs& gr, cudaStream_t s) {
  round1_bwd_kernel<NO_ERT, NEED_DTF, NEED_DVOL>
      <<<march_grid(a), dim3(TILE, TILE), 0, s>>>(a, out, g, gr);
}

template <bool NO_ERT>
void launch_bwd_need(const MarchArgs& a, const float* out, const float* g,
                     const GradArgs& gr, bool dtf, bool dvol, cudaStream_t s) {
  if (dtf) {
    dvol ? launch_bwd_variant<NO_ERT, true, true>(a, out, g, gr, s)
         : launch_bwd_variant<NO_ERT, true, false>(a, out, g, gr, s);
  } else if (dvol) {
    launch_bwd_variant<NO_ERT, false, true>(a, out, g, gr, s);
  }
}

int launch_bwd(const MarchArgs& a, const void* out, const void* g,
               void* d_vol, void* d_tf, int no_ert, int need_dtf,
               int need_dvol, void* stream) {
  const GradArgs gr{static_cast<float*>(d_vol), static_cast<float*>(d_tf)};
  const float* co = static_cast<const float*>(out);
  const float* cg = static_cast<const float*>(g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dtf = need_dtf != 0, dvol = need_dvol != 0;
  no_ert ? launch_bwd_need<true>(a, co, cg, gr, dtf, dvol, s)
         : launch_bwd_need<false>(a, co, cg, gr, dtf, dvol, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All four launch on `stream` and return cudaGetLastError() as an int.
// Shapes, types and contiguity are checked by the Python wrappers. `vol` is
// the f32[D, H, W] density in [0, 1]. For the backwards, `out` is the
// forward's image and `g` its cotangent; `d_vol` and `d_tf` must come in
// zero-filled and are accumulated into.
extern "C" int volrt_diff_tri_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int no_ert, void* stream) {
  return launch_fwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, no_ert, stream);
}

extern "C" int volrt_diff_blocked_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int no_ert, void* stream) {
  return launch_fwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, no_ert, stream);
}

extern "C" int volrt_diff_tri_bwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, const void* out, const void* g,
    void* d_vol, void* d_tf, int n, int width, float step, int max_steps,
    int no_ert, int need_dtf, int need_dvol, void* stream) {
  return launch_bwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, g, d_vol, d_tf, no_ert, need_dtf, need_dvol, stream);
}

extern "C" int volrt_diff_blocked_bwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, const void* out, const void* g,
    void* d_vol, void* d_tf, int n, int width, float step, int max_steps,
    int no_ert, int need_dtf, int need_dvol, void* stream) {
  return launch_bwd(make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                    tf, scal, n, width, step, max_steps),
                    out, g, d_vol, d_tf, no_ert, need_dtf, need_dvol, stream);
}
