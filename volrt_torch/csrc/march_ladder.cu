// Forward march of the renderer ladder's rungs 2-4 on Hopper: one thread per
// ray, 16x16 pixel blocks, as march_fwd.cu.
//
// Two entry points, one body, templated on the voxel type:
//
// - volrt_march_tri replaces volrt/renderers/pallas/trilinear.py:_kernel
//   (rung 3, and rung 2 through its nearest mode): an f32 volume that holds
//   raw voxel values 0..255. Trilinear mode lerps the raw taps along x, then
//   y, then z, divides by 255 once, and reads the lerped TF. Nearest mode
//   addresses one voxel by truncation, reads the TF bucket int(v) / TF_RATIO
//   with no lerp, and scales the shade delta by 1/255.
// - volrt_march_blocked replaces volrt/renderers/pallas/blocked.py:_kernel
//   (rung 4): a uint8 volume of any size in device memory, each tap
//   converted to f32 after its fetch, trilinear only.
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
// replacement giving the same bits as the plain version's operation, so
// that images stay equal to the plain versions' to the bit:
// - every floor and float-to-int conversion (FRND, F2I, on a pipe that
//   retires 16 results a clock an SM) is one round-down add;
// - (p + 1) * 0.5 * n is one product by n / 2 (the product by 0.5 is
//   exact);
// - the second tap along each axis is the first plus 0 or the stride, so
//   the eight addresses are a base and three steps;
// - the TF is staged as padded float4 rows: one clamp, two 16-byte loads;
// - /255 is a product and two FMAs, equal to __fdiv_rn on every f32 in
//   [0, 256), where the lerps of raw values lie (checked on the card over
//   all of them);
// - uint8 taps are widened by I2F: the exponent trick (0x4B000000 | b,
//   less 2^23) takes two instructions for one and measured 6 % slower.
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

constexpr int TF_RATIO = 256 / TF_SIZE;
static_assert(TF_RATIO == 2, "the nearest bucket halves the floor by a shift");

// floor(t) without FRND or F2I. For |t| < 2^22, t + 1.5 * 2^23 rounded
// down lies in [2^23, 2^24), where the f32 values are the integers: it is
// FLOOR_BIAS + floor(t) exactly, so its bits less FLOOR_BITS are floor(t)
// as an int and it less FLOOR_BIAS is floor(t) as a float.
constexpr float FLOOR_BIAS = 0x1.8p23f;
constexpr int FLOOR_BITS = 0x4B400000;

__device__ __forceinline__ float floor_biased(float t) {
  return __fadd_rd(t, FLOOR_BIAS);
}
__device__ __forceinline__ int floor_int(float m) {
  return __float_as_int(m) - FLOOR_BITS;
}

// The volume's edges as the per-sample code takes them: n and n / 2 per
// axis (n / 2 is an f32 for any n under 2^24), and the z stride w * h.
struct Grid {
  float hx, hy, hz;
  int w, h, depth, wh;
};

__device__ __forceinline__ Grid make_grid(const MarchArgs& a) {
  return Grid{0.5f * a.w, 0.5f * a.h, 0.5f * a.depth, a.w, a.h, a.depth,
              a.w * a.h};
}

// One axis of a trilinear sample at p: the first tap's offset (its
// clamped index times the axis's stride), the step to the second tap
// (the stride, or 0 where both clamp to one voxel) and the second tap's
// weight t - floor(t), for t = (p + 1) * 0.5 * n - 0.5. The taps and the
// weight of march_common.cuh:axis_taps for |t| < 2^22, that is for
// |p| < 2^23 / n - 1; the kernel's positions lie in the cube up to
// rounding, the light tap 0.01 beyond (tests/test_torch_ladder_bits.py).
__device__ __forceinline__ void ladder_axis(float p, float half_n, int n,
                                            int stride, int& off, int& step,
                                            float& f) {
  // (p + 1) * 0.5 * n in one product: the product by 0.5 is exact.
  const float t = sub(mul(add(p, 1.f), half_n), 0.5f);
  const float m = floor_biased(t);
  f = sub(t, sub(m, FLOOR_BIAS));
  const int i = floor_int(m);
  off = min(max(i, 0), n - 1) * stride;
  step = static_cast<unsigned>(i) < static_cast<unsigned>(n - 1) ? stride : 0;
}

// One voxel as f32, a uint8 one widened by I2F. As march_common.cuh:voxel,
// at an unsigned offset: its address arithmetic zero-extends, which
// measured 1 % faster on the uint8 rung than voxel's signed index.
template <typename V>
__device__ __forceinline__ float fetch(const V* v, unsigned i) {
  return static_cast<float>(__ldg(v + i));
}

// The trilinear sample at p in the volume's own units: eight
// clamp-addressed taps lerped along x, then y, then z, every product and
// sum rounded on its own as march_common.cuh:sample_taps rounds them.
template <typename V>
__device__ __forceinline__ float ladder_sample(const V* vol, const Grid& g,
                                               float px, float py, float pz) {
  int ox, oy, oz, sx, sy, sz;
  float fx, fy, fz;
  ladder_axis(px, g.hx, g.w, 1, ox, sx, fx);
  ladder_axis(py, g.hy, g.h, g.w, oy, sy, fy);
  ladder_axis(pz, g.hz, g.depth, g.wh, oz, sz, fz);
  const unsigned b00 = ox + oy + oz, b01 = b00 + sy;  // rows (z0,y0), (z0,y1)
  const unsigned b10 = b00 + sz, b11 = b10 + sy;      // rows (z1,y0), (z1,y1)
  const float gx = sub(1.f, fx), gy = sub(1.f, fy), gz = sub(1.f, fz);
  const float c00 = add(mul(fetch(vol, b00), gx), mul(fetch(vol, b00 + sx), fx));
  const float c01 = add(mul(fetch(vol, b01), gx), mul(fetch(vol, b01 + sx), fx));
  const float c10 = add(mul(fetch(vol, b10), gx), mul(fetch(vol, b10 + sx), fx));
  const float c11 = add(mul(fetch(vol, b11), gx), mul(fetch(vol, b11 + sx), fx));
  return add(mul(add(mul(c00, gy), mul(c01, fy)), gz),
             mul(add(mul(c10, gy), mul(c11, fy)), fz));
}

// x / 255 rounded to nearest, as __fdiv_rn(x, 255.f) rounds it, in three
// operations: the product by R = RN(1/255), its exact residual, and one
// correction. Equal to __fdiv_rn on every f32 in [0, 256), where the
// kernel's lerps of raw values 0..255 lie (chip_smoke.py phase 9 checks
// every one on the card). The fused multiply-adds belong to this
// division, not to the forward chain, whose products and sums stay apart.
__device__ __forceinline__ float div255(float x) {
  constexpr float R = 0x1.010102p-8f;
  const float q = __fmul_rn(x, R);
  return __fmaf_rn(__fmaf_rn(-q, 255.f, x), R, q);
}

// The TF in shared memory as RGBA rows, padded with a copy of its first
// and last rows: padded row j + 1 is row j. The lerp's rows clamp(j, 0,
// 127) and clamp(j + 1, 0, 127) are then padded rows j' + 1 and j' + 2
// for j' = clamp(j, -1, 127): one clamp and two 16-byte loads. The caller
// synchronises.
constexpr int LUT_ROWS = TF_SIZE + 2;

__device__ __forceinline__ void stage_padded_lut(const MarchArgs& a,
                                                 float4* lut) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  if (tid < LUT_ROWS) {
    const float* row = a.tf + 4 * min(max(tid - 1, 0), TF_SIZE - 1);
    lut[tid] = make_float4(row[0], row[1], row[2], row[3]);
  }
}

// The lerped TF at density s (march_common.cuh:tf_lerp's RGBA).
__device__ __forceinline__ void tf_rgba(const float4* lut, float s,
                                        float c[4]) {
  const float tc = sub(mul(s, static_cast<float>(TF_SIZE)), 0.5f);
  const float m = floor_biased(tc);
  const float f = sub(tc, sub(m, FLOOR_BIAS));
  const int j = min(max(floor_int(m), -1), TF_SIZE - 1);
  const float4 lo = lut[j + 1], hi = lut[j + 2];
  const float g = sub(1.f, f);
  c[0] = add(mul(lo.x, g), mul(hi.x, f));
  c[1] = add(mul(lo.y, g), mul(hi.y, f));
  c[2] = add(mul(lo.z, g), mul(hi.z, f));
  c[3] = add(mul(lo.w, g), mul(hi.w, f));
}

// The nearest voxel's offset along one axis: clamp(trunc((p + 1) * 0.5 *
// n), 0, n - 1) times the stride (reference: common.h:105-110). The floor
// stands in for the truncation: the two differ only on (-1, 0), where
// both clamp to 0.
__device__ __forceinline__ int nearest_off(float p, float half_n, int n,
                                           int stride) {
  const int i = floor_int(floor_biased(mul(add(p, 1.f), half_n)));
  return min(max(i, 0), n - 1) * stride;
}

template <typename V>
__device__ __forceinline__ float nearest_voxel(const V* vol, const Grid& g,
                                               float px, float py, float pz) {
  return fetch(vol, nearest_off(px, g.hx, g.w, 1) +
                        nearest_off(py, g.hy, g.h, g.w) +
                        nearest_off(pz, g.hz, g.depth, g.wh));
}

// One sample at (px, py, pz) -> its premultiplied, shaded RGBA.
template <typename V, bool NEAREST, bool SHADE>
__device__ __forceinline__ void classify(const Grid& g, const V* vol,
                                         const float4* lut, const Light& li,
                                         float px, float py, float pz,
                                         float c[4]) {
  float s;        // the sample: raw 0..255 in nearest mode, else in [0, 1]
  if (NEAREST) {
    s = nearest_voxel(vol, g, px, py, pz);
    // int(s) / TF_RATIO on raw s >= 0: the floor halved.
    const int bucket =
        min(max(floor_int(floor_biased(s)) >> 1, 0), TF_SIZE - 1);
    const float4 row = lut[bucket + 1];
    c[0] = row.x;
    c[1] = row.y;
    c[2] = row.z;
    c[3] = row.w;
  } else {
    s = div255(ladder_sample(vol, g, px, py, pz));
    tf_rgba(lut, s, c);
  }
  if (SHADE && c[3] > SHADE_ALPHA_GATE && li.kd > SHADE_KD_GATE) {
    float qx, qy, qz, delta;
    light_tap(li, px, py, pz, qx, qy, qz);
    if (NEAREST) {
      const float sl = nearest_voxel(vol, g, qx, qy, qz);
      delta = mul(sub(sl, s), static_cast<float>(1.0 / 255.0));
    } else {
      delta = sub(div255(ladder_sample(vol, g, qx, qy, qz)), s);
    }
    const float diffuse = mul(delta, li.kd);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = add(c[ch], diffuse);
  }
}

template <typename V, bool NEAREST, bool SHADE, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE)
    march_ladder_kernel(MarchArgs a, const V* vol, float* out) {
  __shared__ float4 lut[LUT_ROWS];
  stage_padded_lut(a, lut);
  __syncthreads();

  const int r = ray_index(a);
  if (r < 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.alive[r]) {
    const Ray ray = load_ray(a, r);
    const Light li = load_light(a);
    const Grid g = make_grid(a);
    float k = ray.ks;
    float c[4];
    // One sample an iteration, so that the loop's SASS counts a sample.
#pragma unroll 1
    for (int i = 0; i < a.max_steps; ++i) {
      classify<V, NEAREST, SHADE>(g, vol, lut, li, add(ray.ox, mul(ray.dx, k)),
                                  add(ray.oy, mul(ray.dy, k)),
                                  add(ray.oz, mul(ray.dz, k)), c);
      composite(acc, c);
      k = add(k, a.step);
      if ((!NO_ERT && acc[3] > li.thr) || !(k <= ray.ke)) break;
    }
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
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
// f32[D, H, W] of raw values 0..255 for the first, u8[D, H, W] for the second.
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
    float step, int max_steps, int shade, int no_ert, void* stream) {
  const MarchArgs a = make_march_args(o, d, k0, kfar, alive, nullptr, w, h,
                                      depth, tf, scal, n, width, step,
                                      max_steps);
  return launch<unsigned char, false>(a, vol, out, shade, no_ert, stream);
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
