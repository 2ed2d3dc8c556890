// Forward march of the rung-5 render on Hopper: one thread per ray.
//
// Replaces volrt/renderers/pallas/diff_v3.py:_fwd_kernel in its unshaded
// and diffuse modes over an f32 volume (phong, slab mode, saved samples,
// ESL and bf16 storage are not ported yet). The TPU kernel gathers with
// one-hot matrix products over planned window bricks because Mosaic has no
// per-lane gather; here every ray loads its own eight taps, so none of the
// window planning, brick DMA, x-phase copies or band groups exist, and the
// window-overflow count is 0 by construction.
//
// What bounds it on the card: gather latency and L2 traffic, not
// arithmetic. Each sample is eight dependent-address loads and ~60 flops.
// At 256^3 the f32 density is 64 MiB, more than the 50 MB L2 (a uint8
// copy would be 16 MiB), so a frame streams the volume from device memory
// at least once. The answer here is the 16x16 pixel block: neighbouring
// rays of a block march through neighbouring voxels, so most of a warp's
// taps fall on the same few cache lines and hit in L1 or L2. The
// 128x4 TF LUT is staged in shared memory. Moving to uint8 or bf16
// storage, and TMA-staged bricks, is later work.
//
// The per-sample code is march_common.cuh's, shared with the backward
// kernels. It is the plain torch version's math (volrt_torch/renderers/
// cuda/march.py:march_fwd_plain), op for op, every multiply and add rounded
// on its own, so the two differ only through the light tap's square root.

#include "march_common.cuh"

namespace {

using namespace volrt;

template <bool SHADE, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE) march_fwd_kernel(MarchArgs a,
                                                                float* out) {
  __shared__ float lut[TF_SIZE][4];
  stage_lut(a, lut);
  __syncthreads();

  const int r = ray_index(a);
  if (r < 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.alive[r]) {
    march_forward<SHADE, NO_ERT>(a, lut, load_ray(a, r), load_light(a), acc);
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <bool SHADE, bool NO_ERT>
void launch(const MarchArgs& a, float* out, cudaStream_t stream) {
  march_fwd_kernel<SHADE, NO_ERT><<<march_grid(a), dim3(TILE, TILE), 0, stream>>>(a, out);
}

}  // namespace

// Launches the march on `stream` and returns cudaGetLastError() as an int.
// Shapes, types and contiguity are checked by the Python wrapper.
extern "C" int volrt_march_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int shade, int no_ert, void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, vol, w, h, depth,
                                      tf, scal, n, width, step, max_steps);
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shade) {
    no_ert ? launch<true, true>(a, dst, s) : launch<true, false>(a, dst, s);
  } else {
    no_ert ? launch<false, true>(a, dst, s) : launch<false, false>(a, dst, s);
  }
  return static_cast<int>(cudaGetLastError());
}
