// The ray setup of every march on the card: one thread makes four
// neighbouring rays of a view, in raster order, and where each meets the
// cube.
//
// It has no Pallas counterpart: volrt sets up its rays with XLA ops
// (volrt/core/rays.py:17-80), whose torch version, core/rays.py:get_rays
// and intersect_aabb, is this kernel's plain version
// (volrt_torch/renderers/cuda/rays.py:ray_setup_plain). As torch ops on the
// card that chain was some 40 launches a frame: the host issued them more
// slowly than the card ran them at 1024^2, and at 3840x2160 they streamed
// some 2.5-3 GB of intermediates for 8.3 M rays, three times the march's
// time (PERF.md section 5). Here the rays are made in registers and only
// what the marches and the leap read is written, once: o and d (24 B a
// ray), knear and kfar (8 B), hit (1 B), which is also the marches'
// `alive` before a leap (a hit has knear < kfar). 33 B a ray bound the
// kernel on device memory's bandwidth; a thread's four rays go out as
// 16-byte stores, those of o and d through shared memory so that a warp's
// stores are contiguous.
//
// Each multiply, add, subtract and divide is rounded on its own, in the
// plain version's order (mul/add/sub/__fdiv_rn: no FMA contraction), and
// the reductions over the three axes take torch's order, so every output
// equals the plain version's on the card to the bit: a ray that starts or
// ends one rounding apart could take another sample than the reference's.
//
// One thread also writes the marches' scalars `scal` (threshold, kd, the
// light's position, 0, the loss scale, 0) from the view's light on the
// device: no copy from the host and no launches of fill kernels.

#include "march_common.cuh"

namespace {

using namespace volrt;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ray_setup_kernel(RayArgs a) {
  __shared__ float4 stage[kThreads / 32][3 * 32];
  const long long n = static_cast<long long>(a.w) * a.h;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      RAYS_A_THREAD;
  if (first == 0) {
    a.scal[0] = a.threshold;
    a.scal[1] = a.kd;
    a.scal[2] = a.light[0];
    a.scal[3] = a.light[1];
    a.scal[4] = a.light[2];
    a.scal[5] = 0.f;
    a.scal[6] = a.loss_scale;
    a.scal[7] = 0.f;
  }
  if (first >= n) return;
  float org[3], dir[3], rt[3], up[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    org[c] = a.origin[c];
    dir[c] = a.direction[c];
    rt[c] = a.right[c];
    up[c] = a.up[c];
  }
  int y = static_cast<int>(first / a.w);
  int x = static_cast<int>(first - static_cast<long long>(y) * a.w);
  SetupRay r[RAYS_A_THREAD];
#pragma unroll
  for (int i = 0; i < RAYS_A_THREAD; ++i) {
    r[i] = make_ray(a, org, dir, rt, up, x, y);
    if (++x == a.w) {
      x = 0;
      ++y;
    }
  }
  const int lane = threadIdx.x % 32;
  const long long warp_first = first - lane * RAYS_A_THREAD;
  if (warp_first + 32 * RAYS_A_THREAD <= n) {
    // The whole warp's rays lie in the view: o and d through shared
    // memory, knear and kfar 16 B a lane, hit 4 B a lane.
    float4* st = stage[threadIdx.x / 32];
    store_warp_xyz(st, a.o + 3 * warp_first, r, false, lane);
    store_warp_xyz(st, a.d + 3 * warp_first, r, true, lane);
    *reinterpret_cast<float4*>(a.knear + first) =
        make_float4(r[0].knear, r[1].knear, r[2].knear, r[3].knear);
    *reinterpret_cast<float4*>(a.kfar + first) =
        make_float4(r[0].kfar, r[1].kfar, r[2].kfar, r[3].kfar);
    // A bool is one byte, 0 or 1.
    *reinterpret_cast<unsigned int*>(a.hit + first) =
        r[0].hit | r[1].hit << 8 | r[2].hit << 16 |
        static_cast<unsigned int>(r[3].hit) << 24;
    return;
  }
  // The last warp of the view, ray by ray (static indices keep r in
  // registers).
#pragma unroll
  for (int i = 0; i < RAYS_A_THREAD; ++i) {
    const long long k = first + i;
    if (k >= n) break;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.o[3 * k + c] = r[i].o[c];
      a.d[3 * k + c] = r[i].d[c];
    }
    a.knear[k] = r[i].knear;
    a.kfar[k] = r[i].kfar;
    a.hit[k] = r[i].hit;
  }
}

}  // namespace

// Launches the ray setup of a W x H view on `stream` and returns
// cudaGetLastError() as an int. `origin`, `direction`, `right`, `up` and
// `light` are the view's f32[3] vectors on the device; `lo` and `hi` the
// cube's faces. Writes o, d (f32[W*H, 3]), knear, kfar (f32[W*H]), hit
// (bool[W*H]) and scal (f32[8]); a 0-ray view writes scal alone.
// Shapes, types and contiguity are checked by the Python wrapper.
extern "C" int volrt_ray_setup(
    const void* origin, const void* direction, const void* right,
    const void* up, const void* light, int w, int h, int perspective,
    float lo, float hi, float threshold, float kd, float loss_scale,
    void* o, void* d, void* knear, void* kfar, void* hit, void* scal,
    void* stream) {
  const RayArgs a{static_cast<const float*>(origin),
                  static_cast<const float*>(direction),
                  static_cast<const float*>(right),
                  static_cast<const float*>(up),
                  static_cast<const float*>(light),
                  w, h, perspective, lo, hi, threshold, kd, loss_scale,
                  static_cast<float*>(o), static_cast<float*>(d),
                  static_cast<float*>(knear), static_cast<float*>(kfar),
                  static_cast<bool*>(hit), static_cast<float*>(scal)};
  const long long threads =
      (static_cast<long long>(w) * h + RAYS_A_THREAD - 1) / RAYS_A_THREAD;
  const unsigned int blocks = static_cast<unsigned int>(
      threads > 0 ? (threads + kThreads - 1) / kThreads : 1);
  ray_setup_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
