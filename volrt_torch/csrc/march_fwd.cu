// Forward march of the rung-5 render on Hopper: one thread per ray.
//
// Replaces volrt/renderers/pallas/diff_v3.py:_fwd_kernel in its unshaded,
// diffuse and phong modes over an f32 volume (slab mode, saved samples,
// ESL and bf16 storage are not ported yet). The TPU kernel gathers with
// one-hot matrix products over planned window bricks because Mosaic has no
// per-lane gather; here every ray loads its own eight taps, so none of the
// window planning, brick DMA, x-phase copies or band groups exist, and the
// window-overflow count is 0 by construction.
//
// What bounds it on the card (bench/step_ab.py, PERF.md section 6): the
// same as the ladder's forward march (march_ladder.cu), whose loop it
// shares but for the lattice: instruction issue, then load latency. Not
// device memory (the 64 MiB density is 0.02 ms at 3.35 TB/s, against a
// march of some 1.4 ms) and not the FP32 rate. Each rounded multiply and
// add is an instruction of its own, and at 1024^2 rays of 257 samples the
// issue slots alone take some 77 % of the kernel's time; taps from the
// address with no load measured 11 % faster.
//
// What the design does about it: the per-sample code is march_common.cuh's
// classify (Units::kDensity: a density in [0, 1], no division), shared with
// the ladder, round 1 and the backward's replay, with its fewer
// instructions a sample (no floorf, float-to-int or int-to-float
// conversion on the unshaded path; the taps as a base and three steps; the
// TF as padded float4 rows), each giving the plain version's bits. The
// sample count i of the lattice k0 + i*step is carried as an f32 that
// gains 1 a sample, exact below 2^24, in place of a conversion a sample.
// The 16x16 pixel block keeps a warp's taps on few cache lines.
// Moving to uint8 or bf16 storage, and TMA-staged bricks, is later work.
//
// It is the plain torch version's math (volrt_torch/renderers/
// cuda/march.py:march_fwd_plain), op for op, every multiply and add rounded
// on its own, so the two differ only through the light tap's square root.
//
// Phong (march_common.cuh:shade_phong) adds to each gated sample six
// trilinear samples, the central-difference gradient's taps, and some 280
// rounded operations; at 1024^2 on the benchmark pose, where 41 % of the
// samples open the gate, it takes 3.8 ms against 1.37 unshaded, at 64
// registers (PERF.md section 6). Its normalisations take 1 / sqrt(x) in two
// rounded operations (rsqrt_rn), as the plain version does on either
// device, so its images too equal the plain version's to the bit.

#include "march_common.cuh"

namespace {

using namespace volrt;

template <Shade S, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE) march_fwd_kernel(MarchArgs a,
                                                                float* out) {
  __shared__ float4 lut[LUT_ROWS];
  stage_padded_lut(a, lut);
  __syncthreads();

  const int r = ray_index(a);
  if (r < 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.alive[r]) {
    march_forward<S, NO_ERT>(a, lut, load_ray(a, r), load_light(a), acc);
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <Shade S, bool NO_ERT>
void launch(const MarchArgs& a, float* out, cudaStream_t stream) {
  march_fwd_kernel<S, NO_ERT><<<march_grid(a), dim3(TILE, TILE), 0, stream>>>(a, out);
}

template <Shade S>
void launch_ert(const MarchArgs& a, float* out, bool no_ert, cudaStream_t s) {
  no_ert ? launch<S, true>(a, out, s) : launch<S, false>(a, out, s);
}

}  // namespace

// Launches the march on `stream` and returns cudaGetLastError() as an int.
// `shade` is 0 (none), 1 (the diffuse tap) or 2 (phong). Shapes, types and
// contiguity are checked by the Python wrapper.
extern "C" int volrt_march_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int shade, int no_ert, void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                      tf, scal, n, width, step, max_steps);
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shade == 2) {
    launch_ert<Shade::kPhong>(a, dst, no_ert, s);
  } else if (shade) {
    launch_ert<Shade::kDiffuse>(a, dst, no_ert, s);
  } else {
    launch_ert<Shade::kNone>(a, dst, no_ert, s);
  }
  return static_cast<int>(cudaGetLastError());
}
