// Forward march of the renderer ladder's rungs 2-4 on Hopper: one thread per
// ray, 16x16 pixel blocks, as march_fwd.cu.
//
// Two entry points, one body, templated on the voxel type:
//
// - volrt_march_tri replaces volrt/renderers/pallas/trilinear.py:_kernel
//   (rung 3, and rung 2 through its nearest mode): an f32 volume that holds
//   raw voxel values 0..255. Trilinear mode lerps the raw taps along x, then
//   y, then z, divides by 255 once, and reads the lerped TF. Nearest mode
//   addresses one voxel by truncation, reads the TF bucket int(v) / 2 with
//   no lerp, and scales the shade delta by 1/255.
// - volrt_march_blocked replaces volrt/renderers/pallas/blocked.py:_kernel
//   (rung 4): a uint8 volume of any size in device memory, each tap
//   converted to f32 after its fetch, trilinear only. A volume of 2^31
//   voxels or more takes march_blocked_wide_kernel, the same body with
//   64-bit voxel offsets (march_common.cuh:Unsigned); the wrapper passes
//   `wide`. march_ladder_kernel keeps 32-bit offsets, so its SASS is the
//   one measured below.
//
// What differs from march_fwd.cu (rung 5) is the ray's lattice, not only the
// volume's units: k starts at the ray's own k0 (after the leading empty-space
// leap, which is ray setup) and gains one rounded `+ step` per sample, and
// the ray ends when its next k exceeds kfar (reference: CPURenderer.cpp:35-38).
// After some 250 adds that k differs from k0 + i*step in its last bits, which
// can add or drop a ray's last sample, so this kernel accumulates as rungs 0-1
// do and is held to them.
//
// Not carried over from the TPU kernels: the (wz, wy) windows and their
// overflow count (0 here by construction), the one-hot matrix products, band
// marching and its per-ray band offset, the brick DMA and its pads. Every ray
// loads its own taps.
//
// What bounds it on the card (measured with bench/step_ab.py, PERF.md
// section 6): instruction issue, then load latency. Not device memory and
// not the FP32 rate: every multiply and add of the forward chain is its own
// rounded instruction, so a trilinear sample is some 130-150 warp
// instructions (47 in nearest mode). At 1024^2 rays of 257 samples, 132
// SMs of 4 schedulers issuing one instruction a clock would need about 80 %
// of the kernel's time; taking the eight loads away saves about 10 %.
//
// What the design does about it: fewer instructions a sample, each
// replacement giving the same bits as the plain version's operation, in
// the per-sample code that every march kernel shares
// (march_common.cuh:classify, with Units::kRaw here; its header lists
// them). uint8 taps are widened by I2F: the exponent trick (0x4B000000 |
// b, less 2^23) takes two instructions for one and measured 6 % slower.
// Fetching the next sample's taps ahead of this sample's arithmetic
// measured 4 % faster on the unshaded f32 rung and slower shaded and in
// nearest mode (more registers, fewer blocks an SM), and is not done.
// Bricks in shared memory and TMA are later work.
//
// Every multiply and add is rounded on its own, in the plain torch
// versions' order (volrt_torch/renderers/cuda/march.py: march_tri_plain,
// march_blocked_plain), so kernel and plain version differ only through
// the light tap's square root.

#include "march_common.cuh"

namespace {

using namespace volrt;

template <typename V, bool NEAREST, bool SHADE, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE)
    march_ladder_kernel(MarchArgs a, const V* vol, float* out) {
  __shared__ float4 lut[LUT_ROWS];
  stage_padded_lut(a, lut);
  __syncthreads();
  march_accumulating<V, Units::kRaw, NEAREST, SHADE, NO_ERT>(a, vol, lut,
                                                             out);
}

// Rung 4 on a volume of 2^31 voxels or more: the same march with 64-bit
// voxel offsets.
template <bool SHADE, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE)
    march_blocked_wide_kernel(MarchArgs a, const unsigned char* vol,
                              float* out) {
  __shared__ float4 lut[LUT_ROWS];
  stage_padded_lut(a, lut);
  __syncthreads();
  march_accumulating<unsigned char, Units::kRaw, false, SHADE, NO_ERT,
                     long long>(a, vol, lut, out);
}

template <typename V, bool NEAREST>
int launch(const MarchArgs& a, const void* vol, void* out, int shade,
           int no_ert, void* stream) {
  const V* v = static_cast<const V*>(vol);
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = march_grid(a), block(TILE, TILE);
  if (shade) {
    if (no_ert) march_ladder_kernel<V, NEAREST, true, true><<<grid, block, 0, s>>>(a, v, dst);
    else march_ladder_kernel<V, NEAREST, true, false><<<grid, block, 0, s>>>(a, v, dst);
  } else {
    if (no_ert) march_ladder_kernel<V, NEAREST, false, true><<<grid, block, 0, s>>>(a, v, dst);
    else march_ladder_kernel<V, NEAREST, false, false><<<grid, block, 0, s>>>(a, v, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const MarchArgs& a, const void* vol, void* out, int shade,
                int no_ert, void* stream) {
  const auto* v = static_cast<const unsigned char*>(vol);
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = march_grid(a), block(TILE, TILE);
  if (shade) {
    if (no_ert) march_blocked_wide_kernel<true, true><<<grid, block, 0, s>>>(a, v, dst);
    else march_blocked_wide_kernel<true, false><<<grid, block, 0, s>>>(a, v, dst);
  } else {
    if (no_ert) march_blocked_wide_kernel<false, true><<<grid, block, 0, s>>>(a, v, dst);
    else march_blocked_wide_kernel<false, false><<<grid, block, 0, s>>>(a, v, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

// Counts the x in `x[0..n)` whose div255(x) differs in its bits from
// __fdiv_rn(x, 255.f): one add a warp.
__global__ void div255_check_kernel(const float* x, long long n,
                                    unsigned long long* mismatches) {
  unsigned count = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    count += __float_as_uint(div255(x[i])) !=
             __float_as_uint(__fdiv_rn(x[i], 255.f));
  }
  for (int s = 16; s > 0; s >>= 1) {
    count += __shfl_down_sync(FULL_WARP, count, s);
  }
  if ((threadIdx.x & 31) == 0 && count) {
    atomicAdd(mismatches, static_cast<unsigned long long>(count));
  }
}

}  // namespace

// Both launch the march on `stream` and return cudaGetLastError() as an int.
// Shapes, types and contiguity are checked by the Python wrappers. `vol` is
// f32[D, H, W] of raw values 0..255 for the first, u8[D, H, W] for the second,
// whose `wide` picks 64-bit voxel offsets (a volume of 2^31 voxels or more).
extern "C" int volrt_march_tri(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int nearest, int shade, int no_ert,
    void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, nullptr, w, h,
                                      depth, tf, scal, n, width, step,
                                      max_steps);
  return nearest ? launch<float, true>(a, vol, out, shade, no_ert, stream)
                 : launch<float, false>(a, vol, out, shade, no_ert, stream);
}

extern "C" int volrt_march_blocked(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int shade, int no_ert, int wide,
    void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, nullptr, w, h,
                                      depth, tf, scal, n, width, step,
                                      max_steps);
  return wide ? launch_wide(a, vol, out, shade, no_ert, stream)
              : launch<unsigned char, false>(a, vol, out, shade, no_ert,
                                             stream);
}

// Adds to `mismatches` (a zeroed u64) the count of the n f32 at `x` whose
// quotient by 255 in the kernels' three operations differs from
// __fdiv_rn's; returns cudaGetLastError() as an int.
extern "C" int volrt_div255_check(const void* x, long long n,
                                  void* mismatches, void* stream) {
  div255_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n,
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}
