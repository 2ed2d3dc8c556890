// Forward march of the rung-5 render on Hopper: one thread per ray.
//
// Replaces volrt/renderers/pallas/diff_v3.py:_fwd_kernel in its unshaded,
// diffuse and phong modes, each with ESL and without, and in its slab mode
// (unshaded and diffuse, with ESL and without), over an f32 volume or, in
// its fast mode, a bf16 one (saved samples are not ported). The TPU
// kernel's ESL drops planned groups of samples; here each sample is tested
// (Esl::kOn, march_common.cuh:esl_empty_cell). The TPU kernel gathers with
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
// TMA-staged bricks are later work.
//
// The fast mode (Voxel::kBf16, volrt's fast=True) is an instance of each
// of the above over a bf16 volume: half the bytes a tap, and a sample
// taken as volrt's fast kernels take it (march_common.cuh: cell_at_fast
// and the bf16 trilinear), with four more roundings (the (z, y) weight
// products to bf16) and a widening a tap: 149 SASS instructions a sample
// against 130. The kernel being issue-bound, the halved bytes do not pay:
// 1.54 ms against 1.38 at 256^3 / 1024^2 (PERF.md section 6).
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
//
// The slab mode (Slab::kOn, volume-sharded rendering: dist/volume_sharded.py)
// marches one Z-slab of a deeper volume: the cells are the whole volume's,
// moved to the slab's rows (march_common.cuh:cell_at_slab), and every ray's
// accumulator starts at (0, 0, 0, acc0[r]), the opacity in front of the
// slab, which the output keeps, on a dead ray too. Which samples a slab
// takes is the caller's: each ray's k0 and kfar bound the lattice indices
// of the slab (renderers/diff_v3.py:slab_rays), so the kernel's loop
// (march_common.cuh:march_forward_slab) is the slab-off loop with a seed.

#include "march_common.cuh"

namespace {

using namespace volrt;

template <Shade S, Esl E, Slab SL, Voxel X, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE) march_fwd_kernel(MarchArgs a,
                                                                float* out,
                                                                EslArgs esl,
                                                                SlabArgs sl) {
  __shared__ float4 lut[LUT_ROWS];
  stage_padded_lut(a, lut);
  if constexpr (E == Esl::kOn) {
    __shared__ unsigned words[ESL_DIMS * ESL_DIMS];
    esl = stage_esl(esl, words);
  }
  __syncthreads();

  const int r = ray_index(a);
  if (r < 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (SL == Slab::kOn) acc[3] = sl.acc0[r];
  using V = typename VoxelOf<X>::T;
  if (a.alive[r]) {
    if constexpr (SL == Slab::kOn) {
      march_forward_slab<S, E, NO_ERT, V>(a, lut, esl, load_slab(a, sl),
                                          load_ray(a, r), load_light(a), acc);
    } else {
      march_forward<S, E, NO_ERT, V>(a, lut, esl, load_ray(a, r),
                                     load_light(a), acc);
    }
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <Shade S, Esl E, Slab SL, Voxel X, bool NO_ERT>
void launch(const MarchArgs& a, float* out, const EslArgs& esl,
            const SlabArgs& sl, cudaStream_t stream) {
  march_fwd_kernel<S, E, SL, X, NO_ERT>
      <<<march_grid(a), dim3(TILE, TILE), 0, stream>>>(a, out, esl, sl);
}

template <Shade S, Esl E, Slab SL, Voxel X>
void launch_ert(const MarchArgs& a, float* out, const EslArgs& esl,
                const SlabArgs& sl, bool no_ert, cudaStream_t s) {
  no_ert ? launch<S, E, SL, X, true>(a, out, esl, sl, s)
         : launch<S, E, SL, X, false>(a, out, esl, sl, s);
}

template <Shade S, Slab SL, Voxel X>
void launch_esl(const MarchArgs& a, float* out, const EslArgs& esl,
                const SlabArgs& sl, bool no_ert, cudaStream_t s) {
  esl.words ? launch_ert<S, Esl::kOn, SL, X>(a, out, esl, sl, no_ert, s)
            : launch_ert<S, Esl::kOff, SL, X>(a, out, esl, sl, no_ert, s);
}

template <Voxel X>
int launch_mode(const MarchArgs& a, float* dst, const EslArgs& esl,
                const SlabArgs& sl, int shade, bool no_ert, cudaStream_t s) {
  if (sl.acc0) {
    if (shade == 2) return static_cast<int>(cudaErrorInvalidValue);
    shade ? launch_esl<Shade::kDiffuse, Slab::kOn, X>(a, dst, esl, sl, no_ert,
                                                      s)
          : launch_esl<Shade::kNone, Slab::kOn, X>(a, dst, esl, sl, no_ert, s);
  } else if (shade == 2) {
    launch_esl<Shade::kPhong, Slab::kOff, X>(a, dst, esl, sl, no_ert, s);
  } else if (shade) {
    launch_esl<Shade::kDiffuse, Slab::kOff, X>(a, dst, esl, sl, no_ert, s);
  } else {
    launch_esl<Shade::kNone, Slab::kOff, X>(a, dst, esl, sl, no_ert, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the march on `stream` and returns cudaGetLastError() as an int.
// `shade` is 0 (none), 1 (the diffuse tap) or 2 (phong). `esl_words` is
// the packed ESL grid (u32[32 * 32]) and `esl_block` its block edge in
// voxels, or null and 0 to march every sample. `acc0` (f32[N]) is the slab
// mode's seed and `full_d` the whole volume's depth, z_off in scal[5]; a
// null `acc0` marches the volume whole. The slab mode has no phong (as in
// volrt, diff_v3.py:1448): the wrapper refuses it. `voxel` is the
// volume's type: 0 f32, 1 bf16 (the fast mode). Shapes, types and
// contiguity are checked by the Python wrapper.
extern "C" int volrt_march_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int shade, int no_ert, const void* esl_words,
    int esl_block, const void* acc0, int full_d, int voxel, void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                      tf, scal, n, width, step, max_steps);
  const EslArgs esl = make_esl_args(esl_words, esl_block);
  const SlabArgs sl = make_slab_args(acc0, nullptr, full_d);
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (voxel == 1) {
    return launch_mode<Voxel::kBf16>(a, dst, esl, sl, shade, no_ert != 0, s);
  }
  if (voxel != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mode<Voxel::kF32>(a, dst, esl, sl, shade, no_ert != 0, s);
}
