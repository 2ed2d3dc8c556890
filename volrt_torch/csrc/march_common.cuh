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
// ladder's and the round-1 kernels accumulate k += step instead:
// march_ladder.cu and the round-1 forward in loops of their own, the
// round-1 backward in march_replay_round1); trilinear taps at
// (p+1)*0.5*n - 0.5; the TF lerp at s*TF_SIZE - 0.5;
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

// How a replayed sample's adds to dTF and dVol reach memory: through the
// warp. A warp's lanes sample neighbouring pixels at the same step, so
// their adds land on few addresses: on the benchmark pose a warp-step's 31
// live lanes hit some 7 TF rows (10 lanes on the busiest) and each tap's
// adds land on 5 voxels (volrt_torch/bench/scatter_stats.py). Adds to one
// address serialise, and a float add to shared memory is a compare-and-swap
// loop on this card (ATOMS.CAST.SPIN). So the lanes group by destination
// with __match_any_sync, sum within each group in a shuffle tree
// (reduce_peers), and the group's lowest lane adds once. dTF groups by TF
// row lo, into the warp's own copy of the block's dTF with plain adds (no
// two leaders of a warp share a row, and no other warp writes the copy);
// dVol groups by the sample's trilinear cell, and the leader adds the
// cell's eight sums with global atomics. On a warp whose lanes all differ
// (a noise volume's TF rows) no shuffle round runs.
//
// Every lane of the warp calls the scatter together: march_replay and
// march_replay_round1 keep the warp in one loop until its last ray ends,
// and a lane that adds nothing (its ray ended or never started, or its
// sample has no density cotangent) takes part with `add` false. So every
// collective takes the full warp, and the plain adds cannot race with
// another subset of the warp.
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int WARPS = TILE * TILE / 32;  // warps a block, dTF copies a block

__device__ __forceinline__ int lane_id() {
  return (threadIdx.y * TILE + threadIdx.x) & 31;
}

// The warp's own [TF_SIZE][4] copy of the block's dTF accumulator.
__device__ __forceinline__ auto warp_dtf(float (*dtf)[4]) -> float (*)[4] {
  return dtf + (threadIdx.y * TILE + threadIdx.x) / 32 * TF_SIZE;
}

// Sums v over `peers`, this lane's group (from __match_any_sync), into the
// group's lowest lane and returns true there. A pairwise tree over the
// group's ranks: each round, a lane adds the value of its next remaining
// peer above it, and the lanes of odd rank drop out; ceil(log2(largest
// group in the warp)) rounds of N shuffles. The whole warp calls it.
template <int N>
__device__ __forceinline__ bool reduce_peers(unsigned peers, float (&v)[N]) {
  const int lane = lane_id();
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  const bool leader = rank == 0;
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(FULL_WARP, above != 0u)) {
    const int next = __ffs(above) - 1;
    const int src = next < 0 ? lane : next;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = __shfl_sync(FULL_WARP, v[i], src);
      if (next >= 0) v[i] += t;
    }
    above &= ~__ballot_sync(FULL_WARP, rank & 1u);
    rank >>= 1;
  }
  return leader;
}

// ds times the eight trilinear weights, in the order of add_taps' taps.
__device__ __forceinline__ void tap_weights(const Taps& t, float ds,
                                            float (&w)[8]) {
  const float gx = 1.f - t.fx, gy = 1.f - t.fy, gz = 1.f - t.fz;
  const float w00 = ds * gz * gy, w01 = ds * gz * t.fy;
  const float w10 = ds * t.fz * gy, w11 = ds * t.fz * t.fy;
  w[0] = w00 * gx;
  w[1] = w00 * t.fx;
  w[2] = w01 * gx;
  w[3] = w01 * t.fx;
  w[4] = w10 * gx;
  w[5] = w10 * t.fx;
  w[6] = w11 * gx;
  w[7] = w11 * t.fx;
}

// w added to the eight taps. Two taps that clamp to one voxel add twice, as
// the forward read it twice.
__device__ __forceinline__ void add_taps(float* dv, const Taps& t,
                                         const float (&w)[8]) {
  atomicAdd(dv + t.r00 + t.x0, w[0]);
  atomicAdd(dv + t.r00 + t.x1, w[1]);
  atomicAdd(dv + t.r01 + t.x0, w[2]);
  atomicAdd(dv + t.r01 + t.x1, w[3]);
  atomicAdd(dv + t.r10 + t.x0, w[4]);
  atomicAdd(dv + t.r10 + t.x1, w[5]);
  atomicAdd(dv + t.r11 + t.x0, w[6]);
  atomicAdd(dv + t.r11 + t.x1, w[7]);
}

// ds times the trilinear weights, summed over the warp's lanes that `add`
// to one cell, added to the cell's eight taps.
__device__ __forceinline__ void scatter_taps_warp(float* dv, const Taps& t,
                                                  float ds, bool add) {
  if (!__any_sync(FULL_WARP, add)) return;
  float w[8];
  tap_weights(t, ds, w);
  // The cell's first and last taps name all eight. A lane that does not
  // add takes a key of its own that no cell has (cells' high words are
  // under 2^31), so it groups with no one.
  const unsigned long long cell =
      add ? (static_cast<unsigned long long>(t.r11 + t.x1) << 32) |
                static_cast<unsigned>(t.r00 + t.x0)
          : ~0ull - lane_id();
  if (reduce_peers(__match_any_sync(FULL_WARP, cell), w) && add) {
    add_taps(dv, t, w);
  }
}

// dc times the TF lerp's weights, summed over the warp's lanes on one row
// lo, added to the warp's copy `wdtf` of the block's dTF. Row lo takes
// dc (1 - f) and row lo + 1 takes dc f; a clamped lerp (lo == hi, at
// either end of the TF) gives its whole dc to row lo, so a group keyed by
// lo alone adds to rows lo and lo + 1.
__device__ __forceinline__ void scatter_tf_warp(float (*wdtf)[4],
                                                const Sample& q,
                                                const float dc[4], bool add) {
  const bool one_row = q.lo == q.hi;
  float v[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = one_row ? dc[c] : dc[c] * (1.f - q.f);
    v[4 + c] = one_row ? 0.f : dc[c] * q.f;
  }
  // A lane that does not add takes a key above the TF's rows, its own.
  const int row = add ? q.lo : TF_SIZE + lane_id();
  const bool lead = reduce_peers(__match_any_sync(FULL_WARP, row), v) && add;
  // The leaders' rows lo differ, so their plain adds to row lo cannot
  // collide; row lo + 1 may be another leader's lo, so it waits for the
  // warp. Row TF_SIZE - 1 has only lo == hi, and nothing for the next row.
  if (lead) {
#pragma unroll
    for (int c = 0; c < 4; ++c) wdtf[row][c] += v[c];
  }
  __syncwarp();
  if (lead && row + 1 < TF_SIZE) {
#pragma unroll
    for (int c = 0; c < 4; ++c) wdtf[row + 1][c] += v[4 + c];
  }
  __syncwarp();
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
// colour; wdtf is the warp's [TF_SIZE][4] copy of the block's dTF. IN_RANGE
// drops the density slope at the TF's end points and for a density outside
// (0, 1), as the v3 reference's flag does; without it the slope is
// (tf[hi] - tf[lo]) * TF_SIZE of the clamped rows, zero only where they
// coincide, as the round-1 reference takes it. The whole warp calls this
// (the scatter above), and a lane that is not `live` adds nothing.
template <bool SHADE, bool NEED_DTF, bool NEED_DVOL, bool IN_RANGE>
__device__ __forceinline__ void replay_sample(const float (*lut)[4],
                                              float (*wdtf)[4], float* d_vol,
                                              const Light& li,
                                              const float g4[4], float G,
                                              const Sample& q, Chain& ch,
                                              bool live) {
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

  if (NEED_DTF) scatter_tf_warp(wdtf, q, dc, live);
  if (NEED_DVOL) {
    // The clamped lerp has no slope outside its range (lo == hi there).
    const bool in_range = !IN_RANGE || (q.tc > 0.f && q.tc < TF_SIZE - 1.f &&
                                        q.s > 0.f && q.s < 1.f);
    float ds = 0.f, ds2 = 0.f;
    if (live && in_range) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ds += (lut[q.hi][c] - lut[q.lo][c]) * TF_SIZE * dc[c];
      }
    }
    if (SHADE && live && q.gate) {
      // diffuse = kd * (s2 - s): rgb cotangents flow -kd into this
      // sample's density and +kd into the light tap's. Nothing flows
      // through the gate or the light direction.
      ds2 = li.kd * (dc[0] + dc[1] + dc[2]);
      ds -= ds2;
    }
    if (SHADE) scatter_taps_warp(d_vol, q.t2, ds2, ds2 != 0.f);
    scatter_taps_warp(d_vol, q.t, ds, ds != 0.f);
  }

  ch.acc_a = add(ch.acc_a, mul(q.c[3], T));
}

// What a backward kernel's replay of ray r (-1 outside the image) starts
// from, given the forward's image `out` and its cotangent `g`: the ray, the
// light, the cotangent g4 and G = g4 . out. Returns whether the ray
// replays: it is alive and its cotangent is not all zero (a ray with none
// sends no gradient anywhere). Where it returns false the outputs keep
// what they came in with.
__device__ __forceinline__ bool start_replay(const MarchArgs& a,
                                             const float* out, const float* g,
                                             int r, Ray& ray, Light& li,
                                             float g4[4], float& G) {
  if (r < 0 || !a.alive[r]) return false;
  const float4 gv = reinterpret_cast<const float4*>(g)[r];
  if (gv.x == 0.f && gv.y == 0.f && gv.z == 0.f && gv.w == 0.f) return false;
  const float4 c = reinterpret_cast<const float4*>(out)[r];
  g4[0] = gv.x;
  g4[1] = gv.y;
  g4[2] = gv.z;
  g4[3] = gv.w;
  G = add(add(add(mul(gv.x, c.x), mul(gv.y, c.y)), mul(gv.z, c.z)),
          mul(gv.w, c.w));
  ray = load_ray(a, r);
  li = load_light(a);
  return true;
}

// The replay of one ray on the forward's lattice k0 + i*step. Every lane
// of the warp calls it, those with no ray to replay too (`live` false): the
// lanes stay in one loop until the warp's last ray has ended, each adding
// only while its own ray is live.
template <bool SHADE, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__device__ __forceinline__ void march_replay(const MarchArgs& a,
                                             const float (*lut)[4],
                                             float (*wdtf)[4], float* d_vol,
                                             const Ray& ray, const Light& li,
                                             const float g4[4], float G,
                                             bool live) {
  Sample q{};
  Chain ch;
  for (int i = 0; i < a.max_steps; ++i) {
    if (live) live = take_sample<SHADE>(a, lut, ray, li, i, q);
    if (!__any_sync(FULL_WARP, live)) break;
    replay_sample<SHADE, NEED_DTF, NEED_DVOL, true>(lut, wdtf, d_vol, li, g4,
                                                    G, q, ch, live);
    if (!NO_ERT && ch.acc_a > li.thr) live = false;
  }
}

// The same on round 1's accumulating lattice (march_round1.cu), unshaded
// and with no in-range flag on the slope: k starts at k0 and gains one
// rounded `+ step` per sample, a live ray's first sample is always taken,
// and the ray ends after its sample, when ERT latches or the next k exceeds
// kfar (diff_tri.py:176-178), as the round-1 forward marches. take_sample's
// test before the sample, on the k0 + i*step lattice, would add or drop a
// ray's last sample here.
template <bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__device__ __forceinline__ void march_replay_round1(
    const MarchArgs& a, const float (*lut)[4], float (*wdtf)[4],
    float* d_vol, const Ray& ray, const Light& li, const float g4[4],
    float G, bool live) {
  Sample q{};
  Chain ch;
  float k = ray.ks;
  for (int i = 0; i < a.max_steps; ++i) {
    if (!__any_sync(FULL_WARP, live)) break;
    if (live) sample_at<false>(a, lut, ray, li, k, q);
    replay_sample<false, NEED_DTF, NEED_DVOL, false>(lut, wdtf, d_vol, li,
                                                     g4, G, q, ch, live);
    k = add(k, a.step);
    if (live && ((!NO_ERT && ch.acc_a > li.thr) || !(k <= ray.ke))) {
      live = false;
    }
  }
}

// Clears the block's shared dTF accumulator, `copies` of [TF_SIZE][4].
// The caller synchronises.
__device__ __forceinline__ void clear_dtf(float (*dtf)[4], int copies) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < copies * TF_SIZE * 4; i += TILE * TILE) {
    dtf[i / 4][i % 4] = 0.f;
  }
}

// Adds the block's shared dTF accumulator, the sum of its `copies`, to the
// global one: one atomic per entry that the block touched. The caller
// synchronises first.
__device__ __forceinline__ void flush_dtf(const float (*dtf)[4], int copies,
                                          float* d_tf) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < TF_SIZE * 4; i += TILE * TILE) {
    float v = 0.f;
    for (int k = 0; k < copies; ++k) v += dtf[k * TF_SIZE + i / 4][i % 4];
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
