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
// What bounds it on the card: as march_fwd.cu, gather latency and L1/L2
// traffic, not device memory or arithmetic: eight dependent-address loads
// and some 80 f32 operations per sample (one load and some 30 in nearest
// mode). The uint8 volume is 16 MiB at 256^3 and fits the 50 MB L2, which
// the f32 volume's 64 MiB does not; byte loads are a quarter of the traffic
// but as many load instructions. The 16x16 pixel block keeps a warp's taps on
// a few cache lines; the 128x4 TF LUT is staged in shared memory. Bricks in
// shared memory and TMA are later work.
//
// Every multiply and add is rounded on its own (march_common.cuh), in the
// plain torch versions' order (volrt_torch/renderers/cuda/march.py:
// march_tri_plain, march_blocked_plain), so kernel and plain version differ
// only through the light tap's square root.

#include "march_common.cuh"

namespace {

using namespace volrt;

constexpr int TF_RATIO = 256 / TF_SIZE;

// The nearest voxel's flat index: clamp(trunc((p + 1) * 0.5 * n), 0, n - 1)
// per axis, truncation toward zero (reference: common.h:105-110).
__device__ __forceinline__ int nearest_axis(float p, int n) {
  const int i = __float2int_rz(mul(mul(add(p, 1.f), 0.5f), static_cast<float>(n)));
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ int nearest_index(const MarchArgs& a, float px,
                                             float py, float pz) {
  return (nearest_axis(pz, a.depth) * a.h + nearest_axis(py, a.h)) * a.w +
         nearest_axis(px, a.w);
}

// One sample at (px, py, pz) -> its premultiplied, shaded RGBA.
template <typename V, bool NEAREST, bool SHADE>
__device__ __forceinline__ void classify(const MarchArgs& a, const V* vol,
                                         const float (*lut)[4],
                                         const Light& li, float px, float py,
                                         float pz, float c[4]) {
  float s;        // the sample: raw 0..255 in nearest mode, else in [0, 1]
  if (NEAREST) {
    s = voxel(vol, nearest_index(a, px, py, pz));
    const int bucket = min(max(__float2int_rz(s) / TF_RATIO, 0), TF_SIZE - 1);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) c[ch] = lut[bucket][ch];
  } else {
    float tc, f;
    int lo, hi;
    s = __fdiv_rn(sample_taps(vol, make_taps(a, px, py, pz)), 255.f);
    tf_lerp(lut, s, tc, lo, hi, f, c);
  }
  if (SHADE && c[3] > SHADE_ALPHA_GATE && li.kd > SHADE_KD_GATE) {
    float qx, qy, qz, delta;
    light_tap(li, px, py, pz, qx, qy, qz);
    if (NEAREST) {
      const float sl = voxel(vol, nearest_index(a, qx, qy, qz));
      delta = mul(sub(sl, s), static_cast<float>(1.0 / 255.0));
    } else {
      const float sl =
          __fdiv_rn(sample_taps(vol, make_taps(a, qx, qy, qz)), 255.f);
      delta = sub(sl, s);
    }
    const float diffuse = mul(delta, li.kd);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = add(c[ch], diffuse);
  }
}

template <typename V, bool NEAREST, bool SHADE, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE)
    march_ladder_kernel(MarchArgs a, const V* vol, float* out) {
  __shared__ float lut[TF_SIZE][4];
  stage_lut(a, lut);
  __syncthreads();

  const int r = ray_index(a);
  if (r < 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.alive[r]) {
    const Ray ray = load_ray(a, r);
    const Light li = load_light(a);
    float k = ray.ks;
    float c[4];
    for (int i = 0; i < a.max_steps; ++i) {
      classify<V, NEAREST, SHADE>(a, vol, lut, li, add(ray.ox, mul(ray.dx, k)),
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
