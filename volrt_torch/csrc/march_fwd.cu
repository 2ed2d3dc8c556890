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
// The math is the plain torch version's (volrt_torch/renderers/cuda/
// march.py:march_fwd_plain), op for op: samples at k = k0 + i*step with
// k <= kfar; clamp-addressed trilinear taps at (p+1)*0.5*n - 0.5; the TF
// lerp at s*TF_SIZE - 0.5; premultiplied front-to-back compositing; the
// ERT latch acc.a > threshold after each composite. Every multiply and add
// is rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction), as torch
// rounds them, so the two differ only through the light tap's square root.

#include <cuda_runtime.h>

namespace {

constexpr int TF_SIZE = 128;
constexpr int TILE = 16;
constexpr float SHADE_ALPHA_GATE = 0.05f;
constexpr float SHADE_KD_GATE = 0.01f;
constexpr float SHADE_LIGHT_OFFSET = 0.01f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return add(mul(a, sub(1.f, f)), mul(b, f));
}

struct MarchArgs {
  const float* o;       // [N, 3] ray origins
  const float* d;       // [N, 3] ray directions
  const float* k0;      // [N] first sample's ray parameter
  const float* kfar;    // [N] exit parameter
  const bool* alive;    // [N] ray hits the cube
  const float* vol;     // [D, H, W] density
  int w, h, depth;
  const float* tf;      // [TF_SIZE, 4] premultiplied RGBA
  const float* scal;    // [8]: threshold, kd, light xyz, unused
  float* out;           // [N, 4] RGBA
  int n, width;         // rays, and rays per image row
  float step;
  int max_steps;
};

// Clamp-addressed taps and weight along one axis of n voxels.
__device__ __forceinline__ void axis_taps(float p, int n, int& i0, int& i1,
                                          float& f) {
  const float t = sub(mul(mul(add(p, 1.f), 0.5f), static_cast<float>(n)), 0.5f);
  const float fl = floorf(t);
  f = sub(t, fl);
  // Clamped before the conversion, so no position can address outside.
  const int i = static_cast<int>(fminf(fmaxf(fl, -1.f), static_cast<float>(n)));
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
}

__device__ __forceinline__ float sample(const MarchArgs& a, float px,
                                        float py, float pz) {
  int x0, x1, y0, y1, z0, z1;
  float fx, fy, fz;
  axis_taps(px, a.w, x0, x1, fx);
  axis_taps(py, a.h, y0, y1, fy);
  axis_taps(pz, a.depth, z0, z1, fz);
  const float* v = a.vol;
  const int r00 = (z0 * a.h + y0) * a.w, r01 = (z0 * a.h + y1) * a.w;
  const int r10 = (z1 * a.h + y0) * a.w, r11 = (z1 * a.h + y1) * a.w;
  const float c00 = lerp(__ldg(v + r00 + x0), __ldg(v + r00 + x1), fx);
  const float c01 = lerp(__ldg(v + r01 + x0), __ldg(v + r01 + x1), fx);
  const float c10 = lerp(__ldg(v + r10 + x0), __ldg(v + r10 + x1), fx);
  const float c11 = lerp(__ldg(v + r11 + x0), __ldg(v + r11 + x1), fx);
  return lerp(lerp(c00, c01, fy), lerp(c10, c11, fy), fz);
}

template <bool SHADE, bool NO_ERT>
__global__ void __launch_bounds__(TILE * TILE) march_fwd_kernel(MarchArgs a) {
  __shared__ float lut[TF_SIZE][4];
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < TF_SIZE * 4; i += TILE * TILE) {
    lut[i / 4][i % 4] = a.tf[i];
  }
  __syncthreads();

  const int x = blockIdx.x * TILE + threadIdx.x;
  const int y = blockIdx.y * TILE + threadIdx.y;
  if (x >= a.width || y >= a.n / a.width) return;
  const int r = y * a.width + x;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.alive[r]) {
    const float thr = a.scal[0], kd = a.scal[1];
    const float lx = a.scal[2], ly = a.scal[3], lz = a.scal[4];
    const float ox = a.o[3 * r], oy = a.o[3 * r + 1], oz = a.o[3 * r + 2];
    const float dx = a.d[3 * r], dy = a.d[3 * r + 1], dz = a.d[3 * r + 2];
    const float ks = a.k0[r], ke = a.kfar[r];
    for (int i = 0; i < a.max_steps; ++i) {
      const float k = add(ks, mul(static_cast<float>(i), a.step));
      if (!(k <= ke)) break;
      const float px = add(ox, mul(dx, k));
      const float py = add(oy, mul(dy, k));
      const float pz = add(oz, mul(dz, k));
      const float s = sample(a, px, py, pz);

      const float t = sub(mul(s, static_cast<float>(TF_SIZE)), 0.5f);
      const float fl = floorf(t);
      const float f = sub(t, fl);
      const int j = static_cast<int>(fminf(fmaxf(fl, -1.f), static_cast<float>(TF_SIZE)));
      const int lo = min(max(j, 0), TF_SIZE - 1), hi = min(max(j + 1, 0), TF_SIZE - 1);
      float c[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) c[ch] = lerp(lut[lo][ch], lut[hi][ch], f);

      if (SHADE && c[3] > SHADE_ALPHA_GATE && kd > SHADE_KD_GATE) {
        const float vx = sub(lx, px), vy = sub(ly, py), vz = sub(lz, pz);
        const float len = __fsqrt_rn(add(add(mul(vx, vx), mul(vy, vy)), mul(vz, vz)));
        const float s2 = sample(a, add(px, mul(__fdiv_rn(vx, len), SHADE_LIGHT_OFFSET)),
                                add(py, mul(__fdiv_rn(vy, len), SHADE_LIGHT_OFFSET)),
                                add(pz, mul(__fdiv_rn(vz, len), SHADE_LIGHT_OFFSET)));
        const float diffuse = mul(sub(s2, s), kd);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) c[ch] = add(c[ch], diffuse);
      }

      const float om = sub(1.f, acc[3]);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[ch] = add(acc[ch], mul(c[ch], om));
      if (!NO_ERT && acc[3] > thr) break;
    }
  }
  reinterpret_cast<float4*>(a.out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <bool SHADE, bool NO_ERT>
void launch(const MarchArgs& a, cudaStream_t stream) {
  const int height = a.n / a.width;
  const dim3 grid((a.width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
  march_fwd_kernel<SHADE, NO_ERT><<<grid, dim3(TILE, TILE), 0, stream>>>(a);
}

}  // namespace

// Launches the march on `stream` and returns cudaGetLastError() as an int.
// Shapes, types and contiguity are checked by the Python wrapper.
extern "C" int volrt_march_fwd(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, void* out, int n, int width,
    float step, int max_steps, int shade, int no_ert, void* stream) {
  const MarchArgs a{
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(k0), static_cast<const float*>(kfar),
      static_cast<const bool*>(alive), static_cast<const float*>(vol),
      w, h, depth,
      static_cast<const float*>(tf), static_cast<const float*>(scal),
      static_cast<float*>(out), n, width, step, max_steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shade) {
    no_ert ? launch<true, true>(a, s) : launch<true, false>(a, s);
  } else {
    no_ert ? launch<false, true>(a, s) : launch<false, false>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
