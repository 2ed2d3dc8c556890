// The leading empty-space leap of the renderer ladder's rungs 2-4 on
// Hopper: one thread per ray computes where the ray starts its march.
//
// It has no Pallas counterpart: volrt leaps with XLA ops, a while loop of
// lockstep rounds over every ray (volrt/renderers/batched.py:41-86), which
// the port's plain version (volrt_torch/renderers/batched.py:esl_start_raw)
// repeats as torch ops. In lockstep every round is some 70 small kernels
// and a round runs while any ray of the frame still leaps: at 1024^2 on
// the CLI's default look, 32 rounds and 2295 kernels a frame that left the
// card idle three quarters of the time (PERF.md section 5). Here each ray
// runs its own loop, march_common.cuh:leap_start, and stops when it
// stands in a block with a non-empty neighbour or past kfar; a warp waits
// for its slowest ray only.
//
// The distance grid (core/esl.py:empty_distance_grid, int32[32, 32, 32])
// is built once per TF with the render state (core/types.py), not per
// frame; its 128 KB stay in cache. The march kernels (march_ladder.cu)
// then start from the k0 this kernel returns, which equals the plain
// version's to the bit.

#include "march_common.cuh"

namespace {

using namespace volrt;

__global__ void __launch_bounds__(256) esl_leap_kernel(LeapArgs a,
                                                       float* k0) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < a.n) k0[r] = leap_start(a, r);
}

}  // namespace

// Launches the leap on `stream` and returns cudaGetLastError() as an int.
// `k0` receives each ray's start (f32[n]); `dist` is the int32[32, 32, 32]
// distance grid, `block` the ESL block edge in voxels, `bw_*` a block's
// edge in world units per axis and `min_bw` the least of them. Shapes,
// types and contiguity are checked by the Python wrapper.
extern "C" int volrt_esl_start(
    const void* o, const void* d, const void* knear, const void* kfar,
    const void* hit, const void* dist, int w, int h, int depth, int block,
    float bw_x, float bw_y, float bw_z, float min_bw, float step,
    int max_rounds, int n, void* k0, void* stream) {
  const LeapArgs a{static_cast<const float*>(o),
                   static_cast<const float*>(d),
                   static_cast<const float*>(knear),
                   static_cast<const float*>(kfar),
                   static_cast<const bool*>(hit),
                   static_cast<const int*>(dist),
                   w, h, depth, block,
                   {bw_x, bw_y, bw_z}, min_bw, step, max_rounds, n};
  esl_leap_kernel<<<(n + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<float*>(k0));
  return static_cast<int>(cudaGetLastError());
}
