// Per-sample device code shared by the port's march kernels (march_fwd.cu,
// march_bwd.cu, l2_step.cu, march_ladder.cu, march_round1.cu): ray loading, the clamp-addressed
// trilinear taps, the TF lerp, the one-tap diffuse, the composite with its
// ERT latch, and the replay march that carries the analytic backward.
//
// One copy, so that the backward's replay takes exactly the forward's
// samples, opens the shade gate on the same samples and crosses the ERT
// latch at the same sample: a second copy that rounded one product
// differently could flip a gate and send gradient to a sample the forward
// never composited.
//
// The math is the plain torch version's (volrt_torch/renderers/cuda/
// march.py), op for op: samples at k = k0 + i*step with k <= kfar (the
// ladder's and the round-1 kernels accumulate k += step in loops of their
// own and share the per-sample pieces); trilinear taps at (p+1)*0.5*n - 0.5; the TF lerp at s*TF_SIZE - 0.5;
// premultiplied front-to-back compositing; the ERT latch acc.a > threshold
// after each composite. Every multiply and add of the forward chain is
// rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction), as torch
// rounds them.

#pragma once

#include <cuda_runtime.h>

namespace volrt {

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
  const float* scal;    // [8]: threshold, kd, light xyz, unused, loss scale, unused
  int n, width;         // rays, and rays per image row
  float step;
  int max_steps;
};

// Where the backward accumulates. Both are zero-filled by the caller.
struct GradArgs {
  float* d_vol;         // [D, H, W]
  float* d_tf;          // [TF_SIZE, 4]
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ks, ke;
};

struct Light {
  float thr, kd, lx, ly, lz;
};

// The eight clamp-addressed taps of one trilinear sample.
struct Taps {
  int r00, r01, r10, r11;  // row offsets of (z0,y0), (z0,y1), (z1,y0), (z1,y1)
  int x0, x1;
  float fx, fy, fz;
};

// One classified (and shaded) sample.
struct Sample {
  Taps t;        // the sample's own taps
  Taps t2;       // the light tap's, valid where gate
  float s;       // density
  int lo, hi;    // TF rows
  float f;       // TF lerp weight of row hi
  float tc;      // TF coordinate s*TF_SIZE - 0.5, unclamped
  float c[4];    // premultiplied RGBA, shaded
  bool gate;     // the diffuse tap fired
};

__device__ __forceinline__ Ray load_ray(const MarchArgs& a, int r) {
  return Ray{a.o[3 * r], a.o[3 * r + 1], a.o[3 * r + 2],
             a.d[3 * r], a.d[3 * r + 1], a.d[3 * r + 2],
             a.k0[r], a.kfar[r]};
}

__device__ __forceinline__ Light load_light(const MarchArgs& a) {
  return Light{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4]};
}

// Stages the premultiplied LUT in shared memory. The caller synchronises.
__device__ __forceinline__ void stage_lut(const MarchArgs& a,
                                          float (*lut)[4]) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < TF_SIZE * 4; i += TILE * TILE) {
    lut[i / 4][i % 4] = a.tf[i];
  }
}

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

__device__ __forceinline__ Taps make_taps(const MarchArgs& a, float px,
                                          float py, float pz) {
  int x0, x1, y0, y1, z0, z1;
  Taps t;
  axis_taps(px, a.w, x0, x1, t.fx);
  axis_taps(py, a.h, y0, y1, t.fy);
  axis_taps(pz, a.depth, z0, z1, t.fz);
  t.x0 = x0;
  t.x1 = x1;
  t.r00 = (z0 * a.h + y0) * a.w;
  t.r01 = (z0 * a.h + y1) * a.w;
  t.r10 = (z1 * a.h + y0) * a.w;
  t.r11 = (z1 * a.h + y1) * a.w;
  return t;
}

// One voxel as f32, converted after the fetch (V is float or unsigned char).
template <typename V>
__device__ __forceinline__ float voxel(const V* v, int i) {
  return static_cast<float>(__ldg(v + i));
}

// The trilinear sample of eight taps, in the volume's own units: lerped
// along x, then y, then z.
template <typename V>
__device__ __forceinline__ float sample_taps(const V* v, const Taps& t) {
  const float c00 = lerp(voxel(v, t.r00 + t.x0), voxel(v, t.r00 + t.x1), t.fx);
  const float c01 = lerp(voxel(v, t.r01 + t.x0), voxel(v, t.r01 + t.x1), t.fx);
  const float c10 = lerp(voxel(v, t.r10 + t.x0), voxel(v, t.r10 + t.x1), t.fx);
  const float c11 = lerp(voxel(v, t.r11 + t.x0), voxel(v, t.r11 + t.x1), t.fx);
  return lerp(lerp(c00, c01, t.fy), lerp(c10, c11, t.fy), t.fz);
}

__device__ __forceinline__ float sample(const MarchArgs& a, const Taps& t) {
  return sample_taps(a.vol, t);
}

// The linearly interpolated TF at density s in [0, 1]: the coordinate
// tc = s*TF_SIZE - 0.5, its two clamped rows, the weight f of row hi, and
// the premultiplied RGBA c.
__device__ __forceinline__ void tf_lerp(const float (*lut)[4], float s,
                                        float& tc, int& lo, int& hi, float& f,
                                        float c[4]) {
  tc = sub(mul(s, static_cast<float>(TF_SIZE)), 0.5f);
  const float fl = floorf(tc);
  f = sub(tc, fl);
  const int j = static_cast<int>(fminf(fmaxf(fl, -1.f), static_cast<float>(TF_SIZE)));
  lo = min(max(j, 0), TF_SIZE - 1);
  hi = min(max(j + 1, 0), TF_SIZE - 1);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) c[ch] = lerp(lut[lo][ch], lut[hi][ch], f);
}

// Where the diffuse tap samples: SHADE_LIGHT_OFFSET from p toward the light.
__device__ __forceinline__ void light_tap(const Light& li, float px, float py,
                                          float pz, float& qx, float& qy,
                                          float& qz) {
  const float vx = sub(li.lx, px), vy = sub(li.ly, py), vz = sub(li.lz, pz);
  const float len = __fsqrt_rn(add(add(mul(vx, vx), mul(vy, vy)), mul(vz, vz)));
  qx = add(px, mul(__fdiv_rn(vx, len), SHADE_LIGHT_OFFSET));
  qy = add(py, mul(__fdiv_rn(vy, len), SHADE_LIGHT_OFFSET));
  qz = add(pz, mul(__fdiv_rn(vz, len), SHADE_LIGHT_OFFSET));
}

// Front-to-back premultiplied compositing of one sample's colour.
__device__ __forceinline__ void composite(float acc[4], const float c[4]) {
  const float om = sub(1.f, acc[3]);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) acc[ch] = add(acc[ch], mul(c[ch], om));
}

// The classified (and shaded) sample at ray parameter k.
template <bool SHADE>
__device__ __forceinline__ void sample_at(const MarchArgs& a,
                                          const float (*lut)[4],
                                          const Ray& ray, const Light& li,
                                          float k, Sample& q) {
  const float px = add(ray.ox, mul(ray.dx, k));
  const float py = add(ray.oy, mul(ray.dy, k));
  const float pz = add(ray.oz, mul(ray.dz, k));
  q.t = make_taps(a, px, py, pz);
  q.s = sample(a, q.t);

  tf_lerp(lut, q.s, q.tc, q.lo, q.hi, q.f, q.c);

  q.gate = false;
  if (SHADE && q.c[3] > SHADE_ALPHA_GATE && li.kd > SHADE_KD_GATE) {
    q.gate = true;
    float qx, qy, qz;
    light_tap(li, px, py, pz, qx, qy, qz);
    q.t2 = make_taps(a, qx, qy, qz);
    const float diffuse = mul(sub(sample(a, q.t2), q.s), li.kd);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) q.c[ch] = add(q.c[ch], diffuse);
  }
}

// Sample i of the ray on the lattice k0 + i*step: false once the ray has
// left the cube.
template <bool SHADE>
__device__ __forceinline__ bool take_sample(const MarchArgs& a,
                                            const float (*lut)[4],
                                            const Ray& ray, const Light& li,
                                            int i, Sample& q) {
  const float k = add(ray.ks, mul(static_cast<float>(i), a.step));
  if (!(k <= ray.ke)) return false;
  sample_at<SHADE>(a, lut, ray, li, k, q);
  return true;
}

// The forward march of one live ray: acc must come in as zeros.
template <bool SHADE, bool NO_ERT>
__device__ __forceinline__ void march_forward(const MarchArgs& a,
                                              const float (*lut)[4],
                                              const Ray& ray, const Light& li,
                                              float acc[4]) {
  Sample q;
  for (int i = 0; i < a.max_steps; ++i) {
    if (!take_sample<SHADE>(a, lut, ray, li, i, q)) break;
    composite(acc, q.c);
    if (!NO_ERT && acc[3] > li.thr) break;
  }
}

// ds times the eight trilinear weights, added to the eight taps. Two taps
// that clamp to one voxel add twice, as the forward read it twice.
__device__ __forceinline__ void scatter_taps(float* dv, const Taps& t,
                                             float ds) {
  const float gx = 1.f - t.fx, gy = 1.f - t.fy, gz = 1.f - t.fz;
  const float w00 = ds * gz * gy, w01 = ds * gz * t.fy;
  const float w10 = ds * t.fz * gy, w11 = ds * t.fz * t.fy;
  atomicAdd(dv + t.r00 + t.x0, w00 * gx);
  atomicAdd(dv + t.r00 + t.x1, w00 * t.fx);
  atomicAdd(dv + t.r01 + t.x0, w01 * gx);
  atomicAdd(dv + t.r01 + t.x1, w01 * t.fx);
  atomicAdd(dv + t.r10 + t.x0, w10 * gx);
  atomicAdd(dv + t.r10 + t.x1, w10 * t.fx);
  atomicAdd(dv + t.r11 + t.x0, w11 * gx);
  atomicAdd(dv + t.r11 + t.x1, w11 * t.fx);
}

// The analytic backward of one live ray, as a second march with no
// per-sample storage (volrt/renderers/pallas/diff_v3.py:1907-1957, and the
// suffix-sum identity of diff_tri.py:10-24). With T_i the transmittance
// entering sample i, c_i its colour and g the ray's cotangent,
//   dL/dc_i.rgb = g.rgb * T_i
//   dL/dc_i.a   = g.a * T_i - (sum_{j>i} (g . c_j) T_j) / (1 - c_i.a)
// and the sum over later samples is G - (P + contrib_i), with G = g . out
// known from the forward and P the running prefix of contrib = (g . c) T.
// The division is guarded as the reference guards it: an opaque sample
// (1 - c.a <= 1e-6) hides everything behind it and gets no such term.

// What a replay carries from sample to sample.
struct Chain {
  float acc_a = 0.f;  // opacity composited so far
  float P = 0.f;      // prefix of contrib
};

// One replayed sample q: its cotangent, its adds to dTF and dVol, and the
// chain's step. g4 is the ray's cotangent, G its product with the forward's
// colour; dtf is the block's [TF_SIZE][4] accumulator in shared memory.
// IN_RANGE drops the density slope at the TF's end points and for a density
// outside (0, 1), as the v3 reference's flag does; without it the slope is
// (tf[hi] - tf[lo]) * TF_SIZE of the clamped rows, zero only where they
// coincide, as the round-1 reference takes it.
template <bool SHADE, bool NEED_DTF, bool NEED_DVOL, bool IN_RANGE>
__device__ __forceinline__ void replay_sample(const float (*lut)[4],
                                              float (*dtf)[4], float* d_vol,
                                              const Light& li,
                                              const float g4[4], float G,
                                              const Sample& q, Chain& ch) {
  const float T = sub(1.f, ch.acc_a);
  const float gc = add(add(add(mul(g4[0], q.c[0]), mul(g4[1], q.c[1])),
                           mul(g4[2], q.c[2])), mul(g4[3], q.c[3]));
  const float contrib = mul(gc, T);
  const float s_next = sub(G, add(ch.P, contrib));
  ch.P = add(ch.P, contrib);
  const float denom = sub(1.f, q.c[3]);
  const float t8 = denom > 1e-6f ? __fdiv_rn(s_next, fmaxf(denom, 1e-6f)) : 0.f;
  float dc[4] = {mul(g4[0], T), mul(g4[1], T), mul(g4[2], T),
                 sub(mul(g4[3], T), t8)};

  if (NEED_DTF) {
    const float f0 = 1.f - q.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      atomicAdd(&dtf[q.lo][c], dc[c] * f0);
      atomicAdd(&dtf[q.hi][c], dc[c] * q.f);
    }
  }
  if (NEED_DVOL) {
    // The clamped lerp has no slope outside its range (lo == hi there).
    const bool in_range = !IN_RANGE || (q.tc > 0.f && q.tc < TF_SIZE - 1.f &&
                                        q.s > 0.f && q.s < 1.f);
    float ds = 0.f;
    if (in_range) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ds += (lut[q.hi][c] - lut[q.lo][c]) * TF_SIZE * dc[c];
      }
    }
    if (SHADE && q.gate) {
      // diffuse = kd * (s2 - s): rgb cotangents flow -kd into this
      // sample's density and +kd into the light tap's. Nothing flows
      // through the gate or the light direction.
      const float ds2 = li.kd * (dc[0] + dc[1] + dc[2]);
      ds -= ds2;
      if (ds2 != 0.f) scatter_taps(d_vol, q.t2, ds2);
    }
    if (ds != 0.f) scatter_taps(d_vol, q.t, ds);
  }

  ch.acc_a = add(ch.acc_a, mul(q.c[3], T));
}

// The replay of one live ray on the forward's lattice k0 + i*step.
template <bool SHADE, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__device__ __forceinline__ void march_replay(const MarchArgs& a,
                                             const float (*lut)[4],
                                             float (*dtf)[4], float* d_vol,
                                             const Ray& ray, const Light& li,
                                             const float g4[4], float G) {
  Sample q;
  Chain ch;
  for (int i = 0; i < a.max_steps; ++i) {
    if (!take_sample<SHADE>(a, lut, ray, li, i, q)) break;
    replay_sample<SHADE, NEED_DTF, NEED_DVOL, true>(lut, dtf, d_vol, li, g4,
                                                    G, q, ch);
    if (!NO_ERT && ch.acc_a > li.thr) break;
  }
}

// Clears the block's shared dTF accumulator. The caller synchronises.
__device__ __forceinline__ void clear_dtf(float (*dtf)[4]) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < TF_SIZE * 4; i += TILE * TILE) dtf[i / 4][i % 4] = 0.f;
}

// Adds the block's shared dTF accumulator to the global one: one atomic
// per entry that the block touched. The caller synchronises first.
__device__ __forceinline__ void flush_dtf(const float (*dtf)[4], float* d_tf) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < TF_SIZE * 4; i += TILE * TILE) {
    const float v = dtf[i / 4][i % 4];
    if (v != 0.f) atomicAdd(d_tf + i, v);
  }
}

// Ray index of this thread in raster order, or -1 outside the image.
__device__ __forceinline__ int ray_index(const MarchArgs& a) {
  const int x = blockIdx.x * TILE + threadIdx.x;
  const int y = blockIdx.y * TILE + threadIdx.y;
  return (x < a.width && y < a.n / a.width) ? y * a.width + x : -1;
}

inline dim3 march_grid(const MarchArgs& a) {
  const int height = a.n / a.width;
  return dim3((a.width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
}

inline MarchArgs make_march_args(
    const void* o, const void* d, const void* k0, const void* kfar,
    const void* alive, const void* vol, int w, int h, int depth,
    const void* tf, const void* scal, int n, int width, float step,
    int max_steps) {
  return MarchArgs{
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(k0), static_cast<const float*>(kfar),
      static_cast<const bool*>(alive), static_cast<const float*>(vol),
      w, h, depth,
      static_cast<const float*>(tf), static_cast<const float*>(scal),
      n, width, step, max_steps};
}

}  // namespace volrt
