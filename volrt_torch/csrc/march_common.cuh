// The per-sample code of every march kernel of the port (march_fwd.cu,
// march_bwd.cu, l2_step.cu, march_ladder.cu, march_round1.cu), and the
// loops and the backward's replay built on it: ray loading, the trilinear
// cell and its clamp-addressed taps, nearest mode's voxel, the TF lerp from
// padded rows, the one-tap diffuse, gradient Blinn-Phong and its backward
// chain, the composite with its ERT latch, the warp-level scatter of the
// analytic backward, the v3 kernels' ESL test and the leading leap of
// rungs 2-4 (esl_leap.cu).
//
// One copy, so that the backward's replay takes exactly the forward's
// samples, opens the shade gate on the same samples and crosses the ERT
// latch at the same sample: a second copy that rounded one product
// differently could flip a gate and send gradient to a sample the forward
// never composited. Every kernel classifies its samples through classify()
// below, templated on the volume's units (raw 0..255, or a density in
// [0, 1]) and on the mode; no .cu file holds per-sample code of its own.
//
// The math is the plain torch versions' (volrt_torch/renderers/cuda/
// march.py, round1.py), op for op: trilinear taps at (p+1)*0.5*n - 0.5,
// lerped along x, then y, then z; the TF lerp at s*TF_SIZE - 0.5;
// premultiplied front-to-back compositing; the ERT latch acc.a > threshold
// after each composite. Every multiply and add of the forward chain is
// rounded on its own (__fmul_rn/__fadd_rn: no FMA contraction), as torch
// rounds them, and every place where this code takes another operation
// than the plain version (a round-down add for a floor, padded TF rows for
// two clamps, three operations for a division by 255, a float counter for
// a conversion) gives the same bits (tests/test_torch_ladder_bits.py; the
// division on the card, chip_smoke.py phase 9). So unshaded images equal
// the plain versions' to the bit.
//
// Two lattices. Rung 5 and the v3 backward sample at k = k0 + i*step with
// k <= kfar tested before the sample (march_forward, march_replay). The
// ladder and round 1 accumulate k += step from k0, take a live ray's first
// sample always, and end the ray after the sample where ERT latches or the
// next k exceeds kfar (march_accumulating, march_replay_round1).
//
// What bounds the forward marches on the card (bench/step_ab.py, PERF.md
// section 6): instruction issue, then load latency. Not device memory and
// not the FP32 rate: each rounded multiply and add is an instruction of its
// own, a trilinear sample some 130 of them, and at 1024^2 rays of 257
// samples the issue slots of 132 SMs alone take some 80 % of a forward's
// time; taking the eight loads away saves 10-15 %. So the per-sample code
// is written for fewer instructions: no floorf, float-to-int conversion or
// int-to-float conversion on the unshaded f32 path (they run on a pipe
// that retires 16 results a clock an SM, against 128 for FP32), the eight
// tap addresses as a base and three steps, the TF as padded float4 rows.

#pragma once

#include <cuda_runtime.h>

namespace volrt {

constexpr int TF_SIZE = 128;
constexpr int TILE = 16;
constexpr float SHADE_ALPHA_GATE = 0.05f;
constexpr float SHADE_KD_GATE = 0.01f;
constexpr float SHADE_LIGHT_OFFSET = 0.01f;
// Gradient Blinn-Phong's ambient and specular weights; its exponent, 16,
// is four squarings (volrt_torch/constants.py).
constexpr float PHONG_KA = 0.3f;
constexpr float PHONG_KS = 0.2f;

// How a sample is shaded: not at all, by the reference's one-tap diffuse,
// or by gradient Blinn-Phong over central-difference normals (v3's phong,
// volrt/renderers/pallas/diff_v3.py:1219-1262, 1349-1380). Each mode is an
// instantiation of its own, so that one mode's code never enters another's.
enum class Shade { kNone, kDiffuse, kPhong };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// 1 / sqrt(x) in two rounded operations, as the plain versions take it
// (torch.sqrt, then reciprocal), on the CPU and on the card alike.
// rsqrtf is not correctly rounded, and __frsqrt_rn rounds once: either
// would part from the plain version's bits.
__device__ __forceinline__ float rsqrt_rn(float x) {
  return __fdiv_rn(1.f, __fsqrt_rn(x));
}

struct MarchArgs {
  const float* o;       // [N, 3] ray origins
  const float* d;       // [N, 3] ray directions
  const float* k0;      // [N] first sample's ray parameter
  const float* kfar;    // [N] exit parameter
  const bool* alive;    // [N] ray hits the cube
  const float* vol;     // [D, H, W] density (null where the kernel takes
                        // its volume apart: the ladder's)
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

// Phong's view direction, one per ray: V = -d rsqrt(|d|^2 + 1e-20).
struct Eye {
  float vx, vy, vz;
};

__device__ __forceinline__ Ray load_ray(const MarchArgs& a, int r) {
  return Ray{a.o[3 * r], a.o[3 * r + 1], a.o[3 * r + 2],
             a.d[3 * r], a.d[3 * r + 1], a.d[3 * r + 2],
             a.k0[r], a.kfar[r]};
}

__device__ __forceinline__ Light load_light(const MarchArgs& a) {
  return Light{a.scal[0], a.scal[1], a.scal[2], a.scal[3], a.scal[4]};
}

// The ray's Eye in phong mode; nothing read in the others.
template <Shade S>
__device__ __forceinline__ Eye eye_of(const Ray& r) {
  if constexpr (S == Shade::kPhong) {
    const float inv = rsqrt_rn(add(
        add(add(mul(r.dx, r.dx), mul(r.dy, r.dy)), mul(r.dz, r.dz)), 1e-20f));
    return Eye{mul(-r.dx, inv), mul(-r.dy, inv), mul(-r.dz, inv)};
  } else {
    return Eye{0.f, 0.f, 0.f};
  }
}

// Ray index of this thread in raster order, or -1 outside the image.
__device__ __forceinline__ int ray_index(const MarchArgs& a) {
  const int x = blockIdx.x * TILE + threadIdx.x;
  const int y = blockIdx.y * TILE + threadIdx.y;
  return (x < a.width && y < a.n / a.width) ? y * a.width + x : -1;
}

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

// Voxel offsets, by their signed type I: int for a volume under 2^31
// voxels, the instances every kernel runs, tuned instruction by
// instruction; long long for one of 2^31 voxels or more, which the three
// kernels of volrt's "any size" rows take (march_blocked, diff_blocked_fwd,
// diff_blocked_bwd). The wrapper picks the width from the voxel count
// (renderers/cuda/march.py:wide_offsets). An offset is added to the
// volume's address as its unsigned type: a 32-bit one zero-extends, which
// measured 1 % faster on the uint8 rung than a signed index. A stride
// between two taps (1, w or w * h) stays an int at either width: the
// wrappers refuse a slice w * h of 2^31 voxels or more.
template <typename I> struct Unsigned;
template <> struct Unsigned<int> { using T = unsigned; };
template <> struct Unsigned<long long> { using T = unsigned long long; };

// The volume's edges as the per-sample code takes them: n and n / 2 per
// axis (n / 2 is an f32 for any n under 2^24), and the z stride w * h.
template <typename I = int>
struct Grid {
  float hx, hy, hz;
  int w, h, depth;
  I wh;
};

template <typename I = int>
__device__ __forceinline__ Grid<I> make_grid(const MarchArgs& a) {
  return Grid<I>{0.5f * a.w, 0.5f * a.h, 0.5f * a.depth, a.w, a.h, a.depth,
                 static_cast<I>(a.w) * a.h};
}

// The trilinear cell of one sample: the offset of its first tap, the step
// to the second tap along x, y and z (the axis's stride, or 0 where both
// taps clamp to one voxel), and the second taps' weights. Its eight taps
// are base + {0, sx} + {0, sy} + {0, sz}.
template <typename I = int>
struct Cell {
  typename Unsigned<I>::T base;
  int sx, sy, sz;
  float fx, fy, fz;
};

// One axis of a cell at p: the first tap's offset (its clamped index
// times the axis's stride), the step to the second tap and the second
// tap's weight t - floor(t), for t = (p + 1) * 0.5 * n - 0.5. The plain
// version's floor, clamped taps and weight for |t| < 2^22, that is for
// |p| < 2^23 / n - 1; the kernels' positions lie in the cube up to
// rounding, the light tap 0.01 beyond (tests/test_torch_ladder_bits.py).
// The offset is the product at the width of I: a 64-bit one for a volume
// of 2^31 voxels or more, where a 32-bit product would wrap.
template <typename I>
__device__ __forceinline__ void cell_axis(float p, float half_n, int n,
                                          I stride, I& off, int& step,
                                          float& f) {
  // (p + 1) * 0.5 * n in one product: the product by 0.5 is exact.
  const float t = sub(mul(add(p, 1.f), half_n), 0.5f);
  const float m = floor_biased(t);
  f = sub(t, sub(m, FLOOR_BIAS));
  const int i = floor_int(m);
  off = static_cast<I>(min(max(i, 0), n - 1)) * stride;
  step = static_cast<unsigned>(i) < static_cast<unsigned>(n - 1)
             ? static_cast<int>(stride)
             : 0;
}

template <typename I>
__device__ __forceinline__ Cell<I> cell_at(const Grid<I>& g, float px,
                                           float py, float pz) {
  Cell<I> t;
  I ox, oy, oz;
  cell_axis<I>(px, g.hx, g.w, 1, ox, t.sx, t.fx);
  cell_axis<I>(py, g.hy, g.h, g.w, oy, t.sy, t.fy);
  cell_axis<I>(pz, g.hz, g.depth, g.wh, oz, t.sz, t.fz);
  t.base = ox + oy + oz;
  return t;
}

// The slab mode of the v3 forward and backward (volume-sharded rendering,
// volrt/renderers/pallas/diff_v3.py:838-839, 863-864): the volume the
// kernel holds is one Z-slab of a deeper one, rows z_off .. z_off + depth - 1
// of a volume full_d deep (z_off = slab start less its halo; the halo rows
// are the neighbours' copies). A sample's cell is the whole volume's: z on
// its lattice, both z taps clamped to [0, full_d - 1], then moved to the
// slab's rows and clamped to them. x and y are as cell_at has them. Each
// slab-off instance leaves the mode out and keeps its code.
enum class Slab { kOff, kOn };

struct SlabGrid {
  float hz;     // full_d / 2
  int full_d;   // depth of the whole volume
  int z_off;    // the whole volume's row of the slab's row 0
};

// The slab mode's kernel argument: the per-ray seed, the opacity in front
// of the slab, and (the backward's third output) its cotangent, both [N];
// the whole volume's depth. z_off comes in scal[5], volrt's slot for it.
struct SlabArgs {
  const float* acc0;
  float* dacc0;
  int full_d;
};

inline SlabArgs make_slab_args(const void* acc0, void* dacc0, int full_d) {
  return SlabArgs{static_cast<const float*>(acc0), static_cast<float*>(dacc0),
                  full_d};
}

__device__ __forceinline__ SlabGrid load_slab(const MarchArgs& a,
                                              const SlabArgs& s) {
  return SlabGrid{0.5f * s.full_d, s.full_d, __float2int_rn(a.scal[5])};
}

template <typename I>
__device__ __forceinline__ Cell<I> cell_at_slab(const Grid<I>& g,
                                                const SlabGrid& sg, float px,
                                                float py, float pz) {
  Cell<I> t;
  I ox, oy;
  cell_axis<I>(px, g.hx, g.w, 1, ox, t.sx, t.fx);
  cell_axis<I>(py, g.hy, g.h, g.w, oy, t.sy, t.fy);
  const float tz = sub(mul(add(pz, 1.f), sg.hz), 0.5f);
  const float m = floor_biased(tz);
  t.fz = sub(tz, sub(m, FLOOR_BIAS));
  const int i = floor_int(m);
  const int lo = min(max(min(max(i, 0), sg.full_d - 1) - sg.z_off, 0),
                     g.depth - 1);
  const int hi = min(max(min(max(i + 1, 0), sg.full_d - 1) - sg.z_off, 0),
                     g.depth - 1);
  t.sz = (hi - lo) * static_cast<int>(g.wh);
  t.base = ox + oy + static_cast<I>(lo) * g.wh;
  return t;
}

// One axis of a phong gradient tap: the sample's voxel coordinate t
// clipped to [0, n - 1], shifted by `by` (+1 or -1) and clipped again, as
// v3 takes it (diff_v3.py:1226-1262); its first tap's offset, the step to
// the second and the second's weight. The clipped coordinate needs no
// clamp on its taps: the second steps 0 only at n - 1, with weight 0.
template <typename I>
__device__ __forceinline__ void shifted_axis(float p, float half_n, int n,
                                             I stride, float by, I& off,
                                             int& step, float& f) {
  const float top = static_cast<float>(n - 1);
  const float t = sub(mul(add(p, 1.f), half_n), 0.5f);
  const float u = fminf(fmaxf(add(fminf(fmaxf(t, 0.f), top), by), 0.f), top);
  const float m = floor_biased(u);
  f = sub(u, sub(m, FLOOR_BIAS));
  const int i = floor_int(m);
  off = static_cast<I>(i) * stride;
  step = i < n - 1 ? static_cast<int>(stride) : 0;
}

// The six cells of the central-difference gradient at p, in the order
// x + 1, x - 1, y + 1, y - 1, z + 1, z - 1: each shifts one axis of the
// sample's own cell t and keeps the other two, clamp-addressed as t has
// them.
template <typename I>
__device__ __forceinline__ void gradient_cells(const Grid<I>& g,
                                               const Cell<I>& t, float px,
                                               float py, float pz,
                                               Cell<I> (&c)[6]) {
  I o[3];
  int s;
  float f;
  cell_axis<I>(px, g.hx, g.w, 1, o[0], s, f);
  cell_axis<I>(py, g.hy, g.h, g.w, o[1], s, f);
  cell_axis<I>(pz, g.hz, g.depth, g.wh, o[2], s, f);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float by = k == 0 ? 1.f : -1.f;
    Cell<I>& cx = c[k];
    Cell<I>& cy = c[2 + k];
    Cell<I>& cz = c[4 + k];
    cx = cy = cz = t;
    I off;
    shifted_axis<I>(px, g.hx, g.w, 1, by, off, cx.sx, cx.fx);
    cx.base = off + o[1] + o[2];
    shifted_axis<I>(py, g.hy, g.h, g.w, by, off, cy.sy, cy.fy);
    cy.base = o[0] + off + o[2];
    shifted_axis<I>(pz, g.hz, g.depth, g.wh, by, off, cz.sz, cz.fz);
    cz.base = o[0] + o[1] + off;
  }
}

// One voxel as f32, a uint8 one widened by I2F, at an offset of an
// unsigned type (Unsigned<I>::T).
template <typename V, typename U>
__device__ __forceinline__ float fetch(const V* v, U i) {
  return static_cast<float>(__ldg(v + i));
}

// The trilinear sample of a cell in the volume's own units: the eight
// taps lerped along x, then y, then z, every product and sum rounded on
// its own.
template <typename V, typename I>
__device__ __forceinline__ float trilinear(const V* vol, const Cell<I>& t) {
  using U = typename Unsigned<I>::T;
  const U b00 = t.base, b01 = b00 + t.sy;  // rows (z0,y0), (z0,y1)
  const U b10 = b00 + t.sz, b11 = b10 + t.sy;  // (z1,y0), (z1,y1)
  const float gx = sub(1.f, t.fx), gy = sub(1.f, t.fy), gz = sub(1.f, t.fz);
  const float c00 = add(mul(fetch(vol, b00), gx), mul(fetch(vol, b00 + t.sx), t.fx));
  const float c01 = add(mul(fetch(vol, b01), gx), mul(fetch(vol, b01 + t.sx), t.fx));
  const float c10 = add(mul(fetch(vol, b10), gx), mul(fetch(vol, b10 + t.sx), t.fx));
  const float c11 = add(mul(fetch(vol, b11), gx), mul(fetch(vol, b11 + t.sx), t.fx));
  return add(mul(add(mul(c00, gy), mul(c01, t.fy)), gz),
             mul(add(mul(c10, gy), mul(c11, t.fy)), t.fz));
}

// x / 255 rounded to nearest, as __fdiv_rn(x, 255.f) rounds it, in three
// operations: the product by R = RN(1/255), its exact residual, and one
// correction. Equal to __fdiv_rn on every f32 in [0, 256), where the
// lerps of raw values 0..255 lie (chip_smoke.py phase 9 checks every one
// on the card). The fused multiply-adds belong to this division, not to
// the forward chain, whose products and sums stay apart.
__device__ __forceinline__ float div255(float x) {
  constexpr float R = 0x1.010102p-8f;
  const float q = __fmul_rn(x, R);
  return __fmaf_rn(__fmaf_rn(-q, 255.f, x), R, q);
}

// What a volume holds: raw voxel values 0..255 (the ladder's rungs 2-4),
// divided by 255 after the lerps; or a density in [0, 1] (rung 5, round
// 1, the replays), taken as it is.
enum class Units { kRaw, kDensity };

template <Units U>
__device__ __forceinline__ float density_of(float x) {
  return U == Units::kRaw ? div255(x) : x;
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

// The nearest voxel's offset along one axis: clamp(trunc((p + 1) * 0.5 *
// n), 0, n - 1) times the stride (reference: common.h:105-110). The floor
// stands in for the truncation: the two differ only on (-1, 0), where
// both clamp to 0.
template <typename I>
__device__ __forceinline__ I nearest_off(float p, float half_n, int n,
                                         I stride) {
  const int i = floor_int(floor_biased(mul(add(p, 1.f), half_n)));
  return static_cast<I>(min(max(i, 0), n - 1)) * stride;
}

template <typename V, typename I>
__device__ __forceinline__ float nearest_voxel(const V* vol,
                                               const Grid<I>& g, float px,
                                               float py, float pz) {
  return fetch(vol, static_cast<typename Unsigned<I>::T>(
                        nearest_off<I>(px, g.hx, g.w, 1) +
                        nearest_off<I>(py, g.hy, g.h, g.w) +
                        nearest_off<I>(pz, g.hz, g.depth, g.wh)));
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

// What phong's backward chain reads of a shaded sample: the terms of the
// forward, kept rather than computed again (diff_v3.py:1862-1942).
template <typename I = int>
struct PhongTerms {
  Cell<I> tap[6];    // the gradient's cells (gradient_cells' order)
  float g[3];     // the raw gradient: tap[0] - tap[1], tap[2] - tap[3], ...
  float ginv;     // rsqrt(|g|^2 + 1e-16); the normal is -g ginv
  float l[3];     // the unit light direction L
  float h[3];     // L + V, not normalised
  float hinv;     // rsqrt(|H|^2 + 1e-20)
  float ndl;      // max(n.L, 0)
  float ndh;      // max((n.H) hinv, 0)
  float lit;      // KA + kd ndl
  float rgb0[3];  // the colour before phong
};

// One classified (and shaded) sample. The forwards read its colour; the
// replays read the rest too, and the compiler drops what a caller leaves
// unread.
template <typename I = int>
struct Sample {
  Cell<I> t;     // the sample's own cell (trilinear mode)
  Cell<I> t2;    // the light tap's, valid where gate
  float s;       // the sample: a density in [0, 1], raw in nearest mode
  float tc;      // TF coordinate s*TF_SIZE - 0.5, unclamped
  int j;         // floor(tc) clamped to [-1, TF_SIZE - 1]: the lerp reads
                 // padded rows j + 1 and j + 2
  float f;       // the weight of the second row
  float c[4];    // premultiplied RGBA, shaded
  bool gate;     // the shade gate opened (alpha and kd above their gates)
  bool skip;     // ESL skipped it: c is 0 and nothing else is valid
  PhongTerms<I> ph;  // phong's terms, valid where gate
};

// The lerped TF at q.s: q.tc, q.j, q.f and the colour q.c.
template <typename I>
__device__ __forceinline__ void tf_rgba(const float4* lut, Sample<I>& q) {
  q.tc = sub(mul(q.s, static_cast<float>(TF_SIZE)), 0.5f);
  const float m = floor_biased(q.tc);
  q.f = sub(q.tc, sub(m, FLOOR_BIAS));
  q.j = min(max(floor_int(m), -1), TF_SIZE - 1);
  const float4 lo = lut[q.j + 1], hi = lut[q.j + 2];
  const float g = sub(1.f, q.f);
  q.c[0] = add(mul(lo.x, g), mul(hi.x, q.f));
  q.c[1] = add(mul(lo.y, g), mul(hi.y, q.f));
  q.c[2] = add(mul(lo.z, g), mul(hi.z, q.f));
  q.c[3] = add(mul(lo.w, g), mul(hi.w, q.f));
}

// max(x, 0) as x > 0 ? x : 0, whose strict test is the backward's mask
// (diff_v3.py:1931-1932).
__device__ __forceinline__ float positive(float x) { return x > 0.f ? x : 0.f; }

// Gradient Blinn-Phong on the gated sample q at p, a density in [0, 1]
// (diff_v3.py:1219-1262, 1349-1380), every product and sum rounded on its
// own, in the plain version's order:
//   g = (S(x + 1) - S(x - 1), ...) over gradient_cells' taps, no /2,
//   n = -g ginv, L = (light - p) linv, H = L + V,
//   rgb = rgb (KA + kd max(n.L, 0)) + KS max((n.H) hinv, 0)^16 alpha.
// Alpha is left as it is, so the composite and the ERT latch see the
// unshaded path's opacities.
template <typename V, typename I>
__device__ __forceinline__ void shade_phong(const Grid<I>& g, const V* vol,
                                            const Light& li, const Eye& e,
                                            float px, float py, float pz,
                                            Sample<I>& q) {
  PhongTerms<I>& f = q.ph;
  gradient_cells(g, q.t, px, py, pz, f.tap);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f.g[a] = sub(trilinear(vol, f.tap[2 * a]), trilinear(vol, f.tap[2 * a + 1]));
  }
  f.ginv = rsqrt_rn(add(add(add(mul(f.g[0], f.g[0]), mul(f.g[1], f.g[1])),
                            mul(f.g[2], f.g[2])), 1e-16f));
  const float n[3] = {mul(-f.g[0], f.ginv), mul(-f.g[1], f.ginv),
                      mul(-f.g[2], f.ginv)};
  const float lv[3] = {sub(li.lx, px), sub(li.ly, py), sub(li.lz, pz)};
  const float linv = rsqrt_rn(add(
      add(add(mul(lv[0], lv[0]), mul(lv[1], lv[1])), mul(lv[2], lv[2])),
      1e-20f));
  const float ev[3] = {e.vx, e.vy, e.vz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f.l[a] = mul(lv[a], linv);
    f.h[a] = add(f.l[a], ev[a]);
  }
  f.hinv = rsqrt_rn(add(add(add(mul(f.h[0], f.h[0]), mul(f.h[1], f.h[1])),
                            mul(f.h[2], f.h[2])), 1e-20f));
  f.ndl = positive(add(add(mul(n[0], f.l[0]), mul(n[1], f.l[1])),
                       mul(n[2], f.l[2])));
  f.ndh = positive(mul(add(add(mul(n[0], f.h[0]), mul(n[1], f.h[1])),
                           mul(n[2], f.h[2])), f.hinv));
  const float s2 = mul(f.ndh, f.ndh), s4 = mul(s2, s2), s8 = mul(s4, s4);
  const float spec = mul(mul(PHONG_KS, mul(s8, s8)), q.c[3]);
  f.lit = add(PHONG_KA, mul(li.kd, f.ndl));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    f.rgb0[ch] = q.c[ch];
    q.c[ch] = add(mul(q.c[ch], f.lit), spec);
  }
}

// The sample at (px, py, pz) -> q, its premultiplied, shaded RGBA in q.c.
// Trilinear mode lerps the taps of its cell, takes the density in U's
// units and lerps the TF; nearest mode (raw values only) reads one voxel
// and the TF bucket int(v) / 2 with no lerp, and scales the shade delta by
// 1/255. Phong (a density, trilinear) reads the ray's Eye `e`.
template <typename V, Units U, bool NEAREST, Shade S, typename I>
__device__ __forceinline__ void classify(const Grid<I>& g, const V* vol,
                                         const float4* lut, const Light& li,
                                         float px, float py, float pz,
                                         Sample<I>& q, const Eye& e = Eye{}) {
  static_assert(!NEAREST || U == Units::kRaw, "nearest mode reads raw values");
  static_assert(S != Shade::kPhong || (!NEAREST && U == Units::kDensity),
                "phong shades a trilinear density");
  if (NEAREST) {
    q.s = nearest_voxel(vol, g, px, py, pz);
    // int(s) / 2 on raw s >= 0: the floor halved.
    const int bucket =
        min(max(floor_int(floor_biased(q.s)) >> 1, 0), TF_SIZE - 1);
    const float4 row = lut[bucket + 1];
    q.c[0] = row.x;
    q.c[1] = row.y;
    q.c[2] = row.z;
    q.c[3] = row.w;
  } else {
    q.t = cell_at(g, px, py, pz);
    q.s = density_of<U>(trilinear(vol, q.t));
    tf_rgba(lut, q);
  }
  q.gate = false;
  if constexpr (S == Shade::kPhong) {
    if (q.c[3] > SHADE_ALPHA_GATE && li.kd > SHADE_KD_GATE) {
      q.gate = true;
      shade_phong(g, vol, li, e, px, py, pz, q);
    }
  }
  if (S == Shade::kDiffuse && q.c[3] > SHADE_ALPHA_GATE &&
      li.kd > SHADE_KD_GATE) {
    q.gate = true;
    float qx, qy, qz, delta;
    light_tap(li, px, py, pz, qx, qy, qz);
    if (NEAREST) {
      const float sl = nearest_voxel(vol, g, qx, qy, qz);
      delta = mul(sub(sl, q.s), static_cast<float>(1.0 / 255.0));
    } else {
      q.t2 = cell_at(g, qx, qy, qz);
      delta = sub(density_of<U>(trilinear(vol, q.t2)), q.s);
    }
    const float diffuse = mul(delta, li.kd);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) q.c[ch] = add(q.c[ch], diffuse);
  }
}

// The classified sample of a density ray at ray parameter k.
template <Shade S, typename I>
__device__ __forceinline__ void sample_at(const MarchArgs& a,
                                          const Grid<I>& g,
                                          const float4* lut, const Ray& ray,
                                          const Light& li, const Eye& e,
                                          float k, Sample<I>& q) {
  classify<float, Units::kDensity, false, S>(
      g, a.vol, lut, li, add(ray.ox, mul(ray.dx, k)),
      add(ray.oy, mul(ray.dy, k)), add(ray.oz, mul(ray.dz, k)), q, e);
}

// Empty-space skipping (ESL) of the v3 kernels: a sample is skipped when
// every ESL block of its clamp-addressed trilinear cell, the blocks of its
// low and high tap on each axis (at most eight), is empty under the TF.
// That is the footprint test of volrt's plan-time group compaction
// (volrt/renderers/pallas/diff_v3.py:583-621, brange) taken for one sample
// rather than for a group of them, so this skips what volrt skips and
// more. The grid is the reference's packed bitmask (core/esl.py:
// pack_bitmask): word z * 32 + y, bit x, 1 where the block is empty, 4 KB
// staged in shared memory. A block's edge need not be a power of two (10
// voxels for a volume 300 wide), so a tap's block is its index times a
// magic number, high word: i / b = umulhi(i, ceil(2^32 / b)) for every
// i < 2^30.
//
// A skipped sample composites nothing and its colour is 0, so the ray's
// opacity and the replay's chain stay as they were; the lattice does not
// move (i counts every step). The forward and both replays take their
// samples through take_sample below, so they skip the same ones, which
// the replay's suffix sum needs. Phong's normal taps need no wider
// footprint: a skipped sample has alpha 0, under phong's gate.
enum class Esl { kOff, kOn };

constexpr int ESL_DIMS = 32;

struct EslArgs {
  const unsigned* words;  // [32 * 32] packed emptiness (shared once staged)
  unsigned magic;         // ceil(2^32 / block edge)
};

inline EslArgs make_esl_args(const void* words, int block) {
  return EslArgs{static_cast<const unsigned*>(words),
                 block > 0 ? static_cast<unsigned>(
                                 (0x100000000ull + block - 1) / block)
                           : 0u};
}

// The grid in shared memory, `words` [32 * 32]; the caller synchronises.
__device__ __forceinline__ EslArgs stage_esl(const EslArgs& e,
                                             unsigned* words) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < ESL_DIMS * ESL_DIMS; i += TILE * TILE) {
    words[i] = e.words[i];
  }
  return EslArgs{words, e.magic};
}

// One axis of the cell at p (cell_axis' t and floor, which the compiler
// shares with it): the ESL blocks of its low and high tap.
__device__ __forceinline__ void esl_axis(float p, float half_n, int n,
                                         unsigned magic, unsigned& lo,
                                         unsigned& hi) {
  const int i = floor_int(floor_biased(sub(mul(add(p, 1.f), half_n), 0.5f)));
  lo = __umulhi(static_cast<unsigned>(min(max(i, 0), n - 1)), magic);
  hi = __umulhi(static_cast<unsigned>(min(max(i + 1, 0), n - 1)), magic);
}

// Whether every ESL block of the cell at p is empty.
template <typename I>
__device__ __forceinline__ bool esl_empty_cell(const EslArgs& e,
                                               const Grid<I>& g, float px,
                                               float py, float pz) {
  unsigned x0, x1, y0, y1, z0, z1;
  esl_axis(px, g.hx, g.w, e.magic, x0, x1);
  esl_axis(py, g.hy, g.h, e.magic, y0, y1);
  esl_axis(pz, g.hz, g.depth, e.magic, z0, z1);
  const unsigned bits = (1u << x0) | (1u << x1);
  const unsigned* w = e.words;
  return (w[z0 * ESL_DIMS + y0] & w[z0 * ESL_DIMS + y1] &
          w[z1 * ESL_DIMS + y0] & w[z1 * ESL_DIMS + y1] & bits) == bits;
}

// Sample i of the ray on the lattice k0 + i*step, i counted in f32 (exact
// below 2^24, where max_steps lies): false once the ray has left the cube.
// With ESL a sample whose cell is empty comes back with q.skip set and
// colour 0, its taps never loaded.
template <Shade S, Esl E, typename I>
__device__ __forceinline__ bool take_sample(const MarchArgs& a,
                                            const Grid<I>& g,
                                            const float4* lut, const Ray& ray,
                                            const Light& li, const Eye& e,
                                            const EslArgs& esl, float i,
                                            Sample<I>& q) {
  const float k = add(ray.ks, mul(i, a.step));
  if (!(k <= ray.ke)) return false;
  if constexpr (E == Esl::kOn) {
    q.skip = esl_empty_cell(esl, g, add(ray.ox, mul(ray.dx, k)),
                            add(ray.oy, mul(ray.dy, k)),
                            add(ray.oz, mul(ray.dz, k)));
    if (q.skip) {
      q.c[0] = q.c[1] = q.c[2] = q.c[3] = 0.f;
      q.gate = false;
      return true;
    }
  }
  sample_at<S>(a, g, lut, ray, li, e, k, q);
  return true;
}

// Front-to-back premultiplied compositing of one sample's colour.
__device__ __forceinline__ void composite(float acc[4], const float c[4]) {
  const float om = sub(1.f, acc[3]);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) acc[ch] = add(acc[ch], mul(c[ch], om));
}

// The forward march of one live ray on the lattice k0 + i*step: acc must
// come in as zeros. One sample an iteration, so that the loop's SASS counts
// a sample. `esl` is the staged grid (unread without ESL).
template <Shade S, Esl E, bool NO_ERT>
__device__ __forceinline__ void march_forward(const MarchArgs& a,
                                              const float4* lut,
                                              const EslArgs& esl,
                                              const Ray& ray, const Light& li,
                                              float acc[4]) {
  const Grid<> g = make_grid(a);
  const Eye e = eye_of<S>(ray);
  const float n = static_cast<float>(a.max_steps);
  Sample<> q;
#pragma unroll 1
  for (float i = 0.f; i < n; i = add(i, 1.f)) {
    if (!take_sample<S, E>(a, g, lut, ray, li, e, esl, i, q)) break;
    if (E == Esl::kOn && q.skip) continue;
    composite(acc, q.c);
    if (!NO_ERT && acc[3] > li.thr) break;
  }
}

// The forward march of this thread's ray on the accumulating lattice of
// the ladder and round 1 (k starts at k0 and gains one rounded `+ step` a
// sample; the first sample of a live ray is always taken, and the ray ends
// after the sample where ERT latches or the next k exceeds kfar), its
// image written to out. The caller has staged the padded LUT. I is the
// voxel offsets' type (Unsigned above).
template <typename V, Units U, bool NEAREST, bool SHADE, bool NO_ERT,
          typename I = int>
__device__ __forceinline__ void march_accumulating(const MarchArgs& a,
                                                   const V* vol,
                                                   const float4* lut,
                                                   float* out) {
  const int r = ray_index(a);
  if (r < 0) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.alive[r]) {
    const Ray ray = load_ray(a, r);
    const Light li = load_light(a);
    const Grid<I> g = make_grid<I>(a);
    float k = ray.ks;
    Sample<I> q;
    // One sample an iteration, so that the loop's SASS counts a sample.
#pragma unroll 1
    for (int i = 0; i < a.max_steps; ++i) {
      classify<V, U, NEAREST, SHADE ? Shade::kDiffuse : Shade::kNone>(
          g, vol, lut, li, add(ray.ox, mul(ray.dx, k)),
          add(ray.oy, mul(ray.dy, k)), add(ray.oz, mul(ray.dz, k)), q);
      composite(acc, q.c);
      k = add(k, a.step);
      if ((!NO_ERT && acc[3] > li.thr) || !(k <= ray.ke)) break;
    }
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc[0], acc[1], acc[2], acc[3]);
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
// row, into the warp's own copy of the block's dTF with plain adds (no
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
template <typename I>
__device__ __forceinline__ void tap_weights(const Cell<I>& t, float ds,
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

// w added to the cell's eight taps. Two taps that clamp to one voxel add
// twice (a step of 0), as the forward read it twice.
template <typename I>
__device__ __forceinline__ void add_taps(float* dv, const Cell<I>& t,
                                         const float (&w)[8]) {
  using U = typename Unsigned<I>::T;
  const U b00 = t.base, b01 = b00 + t.sy;
  const U b10 = b00 + t.sz, b11 = b10 + t.sy;
  atomicAdd(dv + b00, w[0]);
  atomicAdd(dv + (b00 + t.sx), w[1]);
  atomicAdd(dv + b01, w[2]);
  atomicAdd(dv + (b01 + t.sx), w[3]);
  atomicAdd(dv + b10, w[4]);
  atomicAdd(dv + (b10 + t.sx), w[5]);
  atomicAdd(dv + b11, w[6]);
  atomicAdd(dv + (b11 + t.sx), w[7]);
}

// A key that names a cell's eight taps. At 32 bits, its first and last
// taps, each a word (the high word under 2^31). At 64 bits, the first tap
// with the three steps' flags below it (a step is the axis's stride or 0):
// under 2^63 for any volume a card holds.
__device__ __forceinline__ unsigned long long cell_key(const Cell<int>& t) {
  return (static_cast<unsigned long long>(t.base + t.sx + t.sy + t.sz)
          << 32) | t.base;
}

__device__ __forceinline__ unsigned long long cell_key(
    const Cell<long long>& t) {
  return t.base << 3 | static_cast<unsigned long long>(t.sx != 0) << 2 |
         static_cast<unsigned long long>(t.sy != 0) << 1 |
         static_cast<unsigned long long>(t.sz != 0);
}

// ds times the trilinear weights, summed over the warp's lanes that `add`
// to one cell, added to the cell's eight taps.
template <typename I>
__device__ __forceinline__ void scatter_taps_warp(float* dv, const Cell<I>& t,
                                                  float ds, bool add) {
  if (!__any_sync(FULL_WARP, add)) return;
  float w[8];
  tap_weights(t, ds, w);
  // A lane that does not add takes a key of its own that no cell has (a
  // cell's key is under 2^63), so it groups with no one.
  const unsigned long long cell = add ? cell_key(t) : ~0ull - lane_id();
  if (reduce_peers(__match_any_sync(FULL_WARP, cell), w) && add) {
    add_taps(dv, t, w);
  }
}

// dc times the TF lerp's weights, summed over the warp's lanes on one row
// lo = clamp(j, 0, 127), added to the warp's copy `wdtf` of the block's
// dTF. Row lo takes dc (1 - f) and row lo + 1 takes dc f; a clamped lerp
// (j = -1 or 127, both rows one) gives its whole dc to row lo, so a group
// keyed by lo alone adds to rows lo and lo + 1.
template <typename I>
__device__ __forceinline__ void scatter_tf_warp(float (*wdtf)[4],
                                                const Sample<I>& q,
                                                const float dc[4], bool add) {
  const bool one_row = q.j < 0 || q.j == TF_SIZE - 1;
  float v[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = one_row ? dc[c] : dc[c] * (1.f - q.f);
    v[4 + c] = one_row ? 0.f : dc[c] * q.f;
  }
  // A lane that does not add takes a key above the TF's rows, its own.
  const int row = add ? max(q.j, 0) : TF_SIZE + lane_id();
  const bool lead = reduce_peers(__match_any_sync(FULL_WARP, row), v) && add;
  // The leaders' rows lo differ, so their plain adds to row lo cannot
  // collide; row lo + 1 may be another leader's lo, so it waits for the
  // warp. Row TF_SIZE - 1 has only one-row lerps, and nothing for the next.
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

// Phong's backward on one gated sample (diff_v3.py:1918-1942): dc comes in
// as the cotangent of the shaded colour and leaves as that of the TF's
// colour (the rgb scaled by lit, alpha also feeding the specular term);
// dg receives the raw gradient's cotangent. With drgb = dc.r + dc.g + dc.b:
//   dlit = rgb0 . dc.rgb,  dndl = kd dlit,
//   dndh = KS 16 ndh^15 alpha drgb,  dc.a += KS ndh^16 drgb,
//   dn = [n.L > 0] dndl L + [(n.H) hinv > 0] dndh hinv H,
//   dg = -ginv dn + ginv^3 (dn . g) g   (n = -g ginv).
// The masks are strict, as the reference's are: where the density is
// flat, g = 0 and n = 0, no cotangent flows through the normal.
template <typename I>
__device__ __forceinline__ void phong_chain(const PhongTerms<I>& f,
                                            const Light& li, float alpha,
                                            float dc[4], float dg[3]) {
  const float drgb = dc[0] + dc[1] + dc[2];
  const float dlit =
      f.rgb0[0] * dc[0] + f.rgb0[1] * dc[1] + f.rgb0[2] * dc[2];
  const float s2 = f.ndh * f.ndh, s4 = s2 * s2, s8 = s4 * s4;
  const float dndl = f.ndl > 0.f ? li.kd * dlit : 0.f;
  // dndh hinv: (n.H) hinv's cotangent carried to n.H.
  const float dnh = f.ndh > 0.f ? PHONG_KS * 16.f * (s8 * s4 * s2 * f.ndh) *
                                      alpha * drgb * f.hinv
                                : 0.f;
  dc[3] += PHONG_KS * (s8 * s8) * drgb;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) dc[ch] *= f.lit;
  float dn[3], dng = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    dn[a] = dndl * f.l[a] + dnh * f.h[a];
    dng += dn[a] * f.g[a];
  }
  const float g3 = f.ginv * f.ginv * f.ginv;
#pragma unroll
  for (int a = 0; a < 3; ++a) dg[a] = -f.ginv * dn[a] + g3 * dng * f.g[a];
}

// One replayed sample q: its cotangent, its adds to dTF and dVol, and the
// chain's step. g4 is the ray's cotangent, G its product with the forward's
// colour; wdtf is the warp's [TF_SIZE][4] copy of the block's dTF. IN_RANGE
// drops the density slope at the TF's end points and for a density outside
// (0, 1), as the v3 reference's flag does; without it the slope is
// (tf[hi] - tf[lo]) * TF_SIZE of the clamped rows (padded rows j + 2 and
// j + 1), zero only where they coincide, as the round-1 reference takes
// it. In phong mode dTF and the slope take the cotangent of the TF's
// colour (phong_chain), and dVol also gets +-dg at the gradient's six
// cells, each a scatter of its own: seven cells, 56 voxels a sample. The
// whole warp calls this (the scatter above), and a lane that is not
// `live` adds nothing.
template <Shade S, bool NEED_DTF, bool NEED_DVOL, bool IN_RANGE,
          typename I>
__device__ __forceinline__ void replay_sample(const float4* lut,
                                              float (*wdtf)[4], float* d_vol,
                                              const Light& li,
                                              const float g4[4], float G,
                                              const Sample<I>& q, Chain& ch,
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
  // Phong's code is compiled into its own mode only (if constexpr): the
  // other modes' instantiations do not carry it.
  float dg[3];
  if constexpr (S == Shade::kPhong) {
    dg[0] = dg[1] = dg[2] = 0.f;
    if (live && q.gate) phong_chain(q.ph, li, q.c[3], dc, dg);
  }

  if (NEED_DTF) scatter_tf_warp(wdtf, q, dc, live);
  if (NEED_DVOL) {
    // The clamped lerp has no slope outside its range (one row there).
    const bool in_range = !IN_RANGE || (q.tc > 0.f && q.tc < TF_SIZE - 1.f &&
                                        q.s > 0.f && q.s < 1.f);
    float ds = 0.f, ds2 = 0.f;
    if (live && in_range) {
      const float4 lo = lut[q.j + 1], hi = lut[q.j + 2];
      const float slope[4] = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z,
                              hi.w - lo.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) ds += slope[c] * TF_SIZE * dc[c];
    }
    if (S == Shade::kDiffuse && live && q.gate) {
      // diffuse = kd * (s2 - s): rgb cotangents flow -kd into this
      // sample's density and +kd into the light tap's. Nothing flows
      // through the gate or the light direction.
      ds2 = li.kd * (dc[0] + dc[1] + dc[2]);
      ds -= ds2;
    }
    if (S == Shade::kDiffuse) scatter_taps_warp(d_vol, q.t2, ds2, ds2 != 0.f);
    scatter_taps_warp(d_vol, q.t, ds, ds != 0.f);
    if constexpr (S == Shade::kPhong) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float v = k & 1 ? -dg[k / 2] : dg[k / 2];
        scatter_taps_warp(d_vol, q.ph.tap[k], v, live && q.gate && v != 0.f);
      }
    }
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
// only while its own ray is live. With ESL a skipped sample takes part as
// a lane that adds nothing (its colour 0 leaves the chain as it was), and
// a step where no live lane of the warp has a sample is passed over whole.
template <Shade S, Esl E, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__device__ __forceinline__ void march_replay(const MarchArgs& a,
                                             const float4* lut,
                                             const EslArgs& esl,
                                             float (*wdtf)[4], float* d_vol,
                                             const Ray& ray, const Light& li,
                                             const float g4[4], float G,
                                             bool live) {
  const Grid<> g = make_grid(a);
  const Eye e = eye_of<S>(ray);
  const float n = static_cast<float>(a.max_steps);
  Sample<> q{};
  Chain ch;
  for (float i = 0.f; i < n; i = add(i, 1.f)) {
    if (live) live = take_sample<S, E>(a, g, lut, ray, li, e, esl, i, q);
    if (!__any_sync(FULL_WARP, live)) break;
    bool adds = live;
    if constexpr (E == Esl::kOn) {
      adds = live && !q.skip;
      if (!__any_sync(FULL_WARP, adds)) continue;
    }
    replay_sample<S, NEED_DTF, NEED_DVOL, true>(lut, wdtf, d_vol, li, g4, G,
                                                q, ch, adds);
    if (!NO_ERT && ch.acc_a > li.thr) live = false;
  }
}

// The slab mode's sample, march and replay (march_fwd.cu, march_bwd.cu):
// classify's trilinear density path and its diffuse tap on the cells of
// cell_at_slab, take_sample's ESL test on the whole volume's cell
// (diff_v3.py:601-604), and march_forward's and march_replay's loops with
// the seed. They stand apart from the functions above, which the slab-off
// kernels keep as they were, so that those kernels' code stays what it
// was (the one-launch step's shaded variants are sensitive to the least
// change of what is inlined into them).
template <Shade S, typename I>
__device__ __forceinline__ void classify_slab(const Grid<I>& g,
                                              const SlabGrid& sg,
                                              const float* vol,
                                              const float4* lut,
                                              const Light& li, float px,
                                              float py, float pz,
                                              Sample<I>& q) {
  static_assert(S != Shade::kPhong, "the slab mode has no phong");
  q.t = cell_at_slab(g, sg, px, py, pz);
  q.s = trilinear(vol, q.t);
  tf_rgba(lut, q);
  q.gate = false;
  if (S == Shade::kDiffuse && q.c[3] > SHADE_ALPHA_GATE &&
      li.kd > SHADE_KD_GATE) {
    q.gate = true;
    float qx, qy, qz;
    light_tap(li, px, py, pz, qx, qy, qz);
    q.t2 = cell_at_slab(g, sg, qx, qy, qz);
    const float diffuse = mul(sub(trilinear(vol, q.t2), q.s), li.kd);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) q.c[ch] = add(q.c[ch], diffuse);
  }
}

// take_sample in slab mode: sample i of k0 + i*step, false past kfar.
template <Shade S, Esl E>
__device__ __forceinline__ bool take_sample_slab(const MarchArgs& a,
                                                 const Grid<>& g,
                                                 const SlabGrid& sg,
                                                 const float4* lut,
                                                 const Ray& ray,
                                                 const Light& li,
                                                 const EslArgs& esl, float i,
                                                 Sample<>& q) {
  const float k = add(ray.ks, mul(i, a.step));
  if (!(k <= ray.ke)) return false;
  const float px = add(ray.ox, mul(ray.dx, k));
  const float py = add(ray.oy, mul(ray.dy, k));
  const float pz = add(ray.oz, mul(ray.dz, k));
  if constexpr (E == Esl::kOn) {
    Grid<> whole = g;
    whole.hz = sg.hz;
    whole.depth = sg.full_d;
    q.skip = esl_empty_cell(esl, whole, px, py, pz);
    if (q.skip) {
      q.c[0] = q.c[1] = q.c[2] = q.c[3] = 0.f;
      q.gate = false;
      return true;
    }
  }
  classify_slab<S>(g, sg, a.vol, lut, li, px, py, pz, q);
  return true;
}

// march_forward in slab mode: acc comes in as (0, 0, 0, acc0), the
// opacity in front of the slab, and the samples composite behind it; a
// ray whose seed is over the ERT threshold takes none (diff_v3.py:
// 1410-1413).
template <Shade S, Esl E, bool NO_ERT>
__device__ __forceinline__ void march_forward_slab(const MarchArgs& a,
                                                   const float4* lut,
                                                   const EslArgs& esl,
                                                   const SlabGrid& sg,
                                                   const Ray& ray,
                                                   const Light& li,
                                                   float acc[4]) {
  if (!NO_ERT && acc[3] > li.thr) return;
  const Grid<> g = make_grid(a);
  const float n = static_cast<float>(a.max_steps);
  Sample<> q;
#pragma unroll 1
  for (float i = 0.f; i < n; i = add(i, 1.f)) {
    if (!take_sample_slab<S, E>(a, g, sg, lut, ray, li, esl, i, q)) break;
    if (E == Esl::kOn && q.skip) continue;
    composite(acc, q.c);
    if (!NO_ERT && acc[3] > li.thr) break;
  }
}

// march_replay in slab mode: the chain starts from the seed acc0
// (diff_v3.py:2292-2295), G must come in without the seed's share g.a
// acc0, a ray whose seed is over the ERT threshold replays nothing, and
// the prefix P of the ray's contributions as it stood at its last replayed
// sample is returned (a lane whose ray has ended goes on through
// replay_sample with the warp, adding nothing but growing its chain).
template <Shade S, Esl E, bool NO_ERT, bool NEED_DTF, bool NEED_DVOL>
__device__ __forceinline__ float march_replay_slab(
    const MarchArgs& a, const float4* lut, const EslArgs& esl,
    const SlabGrid& sg, float (*wdtf)[4], float* d_vol, const Ray& ray,
    const Light& li, const float g4[4], float G, bool live, float acc0) {
  const Grid<> g = make_grid(a);
  const float n = static_cast<float>(a.max_steps);
  Sample<> q{};
  Chain ch;
  ch.acc_a = acc0;
  float P = 0.f;
  if (!NO_ERT && acc0 > li.thr) live = false;
  for (float i = 0.f; i < n; i = add(i, 1.f)) {
    if (live) live = take_sample_slab<S, E>(a, g, sg, lut, ray, li, esl, i, q);
    if (!__any_sync(FULL_WARP, live)) break;
    bool adds = live;
    if constexpr (E == Esl::kOn) {
      adds = live && !q.skip;
      if (!__any_sync(FULL_WARP, adds)) continue;
    }
    replay_sample<S, NEED_DTF, NEED_DVOL, true>(lut, wdtf, d_vol, li, g4, G,
                                                q, ch, adds);
    if (adds) P = ch.P;
    if (!NO_ERT && ch.acc_a > li.thr) live = false;
  }
  return P;
}

// The same on round 1's accumulating lattice (march_round1.cu), unshaded
// and with no in-range flag on the slope: k starts at k0 and gains one
// rounded `+ step` per sample, a live ray's first sample is always taken,
// and the ray ends after its sample, when ERT latches or the next k exceeds
// kfar (diff_tri.py:176-178), as the round-1 forward marches. take_sample's
// test before the sample, on the k0 + i*step lattice, would add or drop a
// ray's last sample here. I is the voxel offsets' type (Unsigned above).
template <bool NO_ERT, bool NEED_DTF, bool NEED_DVOL, typename I = int>
__device__ __forceinline__ void march_replay_round1(
    const MarchArgs& a, const float4* lut, float (*wdtf)[4],
    float* d_vol, const Ray& ray, const Light& li, const float g4[4],
    float G, bool live) {
  const Grid<I> g = make_grid<I>(a);
  Sample<I> q{};
  Chain ch;
  float k = ray.ks;
  for (int i = 0; i < a.max_steps; ++i) {
    if (!__any_sync(FULL_WARP, live)) break;
    if (live) sample_at<Shade::kNone>(a, g, lut, ray, li, Eye{}, k, q);
    replay_sample<Shade::kNone, NEED_DTF, NEED_DVOL, false>(
        lut, wdtf, d_vol, li, g4, G, q, ch, live);
    k = add(k, a.step);
    if (live && ((!NO_ERT && ch.acc_a > li.thr) || !(k <= ray.ke))) {
      live = false;
    }
  }
}

// The leading empty-space leap of rungs 2-4, one ray a thread: where each
// ray starts its march (volrt_torch/renderers/batched.py:esl_start_raw,
// volrt/renderers/batched.py:41-86). A ray in a block m blocks (Chebyshev,
// the distance grid of core/esl.py:empty_distance_grid) from the nearest
// non-empty one leaps the larger of the way to its block's exit face and
// m - 1 block widths, each rounded down to whole steps, plus one step,
// until it stands in a block with m == 0 or past kfar, at most max_rounds
// times. Every operation is the plain version's, rounded alike: the
// divisions by a tensor (not a product with a reciprocal), the norm
// (x*x + y*y) + z*z, the voxel index truncated as torch's int64 cast
// truncates; so k0 equals the plain version's to the bit.
struct LeapArgs {
  const float* o;       // [N, 3]
  const float* d;       // [N, 3]
  const float* knear;   // [N]
  const float* kfar;    // [N]
  const bool* hit;      // [N]
  const int* dist;      // [32, 32, 32] distance grid, [z, y, x]
  int w, h, depth, block;
  float bw[3];          // a block's edge in world units, x, y, z
  float min_bw;         // the least of bw
  float step;
  int max_rounds, n;
};

// The ESL block along one axis of world coordinate p: the voxel
// trunc((p + 1) * 0.5 * n), clamped, over the block edge.
__device__ __forceinline__ int leap_block(float p, int n, int block) {
  const int i = __float2int_rz(mul(mul(add(p, 1.f), 0.5f),
                                   static_cast<float>(n)));
  return min(max(i, 0), n - 1) / block;
}

// The ray parameter from p to the far face of its block `b` along one
// axis (core/esl.py:leap_distance), 100 where the ray does not move along
// it.
__device__ __forceinline__ float leap_face(float p, float d, int b,
                                           float bw) {
  if (d == 0.f) return 100.f;
  const float face = add(-1.f, mul(bw, static_cast<float>(b + (d > 0.f))));
  return __fdiv_rn(sub(face, p), d);
}

__device__ __forceinline__ float leap_start(const LeapArgs& a, int r) {
  float k = a.knear[r];
  if (!a.hit[r]) return k;
  const float ox = a.o[3 * r], oy = a.o[3 * r + 1], oz = a.o[3 * r + 2];
  const float dx = a.d[3 * r], dy = a.d[3 * r + 1], dz = a.d[3 * r + 2];
  const float ke = a.kfar[r];
  // Perspective directions are not normalised: the safe radius in world
  // units becomes one in ray parameters.
  const float dnorm = __fsqrt_rn(
      add(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)), 1e-20f));
#pragma unroll 1
  for (int i = 0; i < a.max_rounds; ++i) {
    const float px = add(ox, mul(dx, k)), py = add(oy, mul(dy, k)),
                pz = add(oz, mul(dz, k));
    const int bx = leap_block(px, a.w, a.block);
    const int by = leap_block(py, a.h, a.block);
    const int bz = leap_block(pz, a.depth, a.block);
    const int m = a.dist[(bz * ESL_DIMS + by) * ESL_DIMS + bx];
    if (!(k <= ke) || m < 1) break;
    float dk = fminf(fminf(leap_face(px, dx, bx, a.bw[0]),
                           leap_face(py, dy, by, a.bw[1])),
                     leap_face(pz, dz, bz, a.bw[2]));
    dk = dk < 0.f ? 0.f : dk;
    const float face = mul(floorf(__fdiv_rn(dk, a.step)), a.step);
    const float ball = mul(
        floorf(__fdiv_rn(__fdiv_rn(mul(static_cast<float>(m - 1), a.min_bw),
                                   dnorm),
                         a.step)),
        a.step);
    k = add(add(k, fmaxf(face, ball)), a.step);
  }
  return k;
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
