// The trainer's update: one Adam step of a trained leaf and, in the same
// pass, its clamp to [0, 1] (volrt_torch/train/adam.py:adam_step).
//
// It replaces no Pallas kernel: volrt updates with optax.adam and clips
// with jnp.clip, both XLA ops (volrt/train/fit.py:47, 98-99). Its plain
// version is torch.optim.Adam's single-tensor step followed by clamp_
// (train/adam.py:adam_step_plain); torch.optim.Adam on the card ran some
// 16-20 passes over f32 arrays (foreach lerp, mul, addcmul, sqrt into a
// temporary of the leaf's size, div, add, addcdiv, then two clamps).
//
// It is bound by device memory's bandwidth: p, g, m and v read and p, m
// and v written, 28 B an element, some 12 ms for the 1.44e9 voxels of a
// 448 x 1792^2 slab at 3.35 TB/s, against a few operations an element.
// So each byte moves once: every thread takes four neighbouring elements
// of each stream as one 16-byte load or store, nothing is written but the
// three results. The wrapper launches a thread for every four elements;
// the loop strides, so that any grid covers the leaf.
// The arithmetic, in the plain version's order and rounding, is
// adam.cuh's. Element counts are 64-bit; the last n % 4 elements are
// taken one by one.

#include "adam.cuh"

namespace {

using namespace volrt;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) adam_kernel(AdamArgs a) {
  const long long quads = a.n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = first; i < quads; i += stride) adam_quad(a, i);
  const long long k = 4 * quads + first;
  if (k < a.n) a.p[k] = adam_element(a, a.p[k], a.g[k], a.m[k], a.v[k]);
}

}  // namespace

// Launches one Adam step of n f32 elements on `stream` with `blocks`
// blocks of 256 threads, and returns cudaGetLastError() as an int. p, m
// and v are updated in place; with `clamp`, p is clamped to [lo, hi] in
// the same pass. The scalars are the plain version's (train/adam.py),
// computed on the host in double and rounded to f32. Every pointer is
// 16-byte aligned, the tensors contiguous: the Python wrapper checks.
extern "C" int volrt_adam(void* p, const void* g, void* m, void* v,
                          long long n, float w1, float beta2, float w2,
                          float neg_step, float bc2_sqrt, float eps,
                          float lo, float hi, int clamp, int blocks,
                          void* stream) {
  const AdamArgs a{static_cast<float*>(p), static_cast<const float*>(g),
                   static_cast<float*>(m), static_cast<float*>(v),
                   n, w1, beta2, w2, neg_step, bc2_sqrt, eps, lo, hi,
                   clamp};
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
