// The dense parameters' Adagrad, every leaf in one launch, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package updates its dense parameters
// with optax.adagrad(initial_accumulator_value=0, eps=1e-10)
// (dlrm_tpu/train/optim.py:110), which XLA fuses into its step on the TPU.
// The port ran the same update as about ten PyTorch elementwise kernels a
// leaf, ~160 launches a step from Python for the 16 leaves of the MLPerf
// towers, with the card idle behind them.  This kernel updates up to
// kMaxLeaves leaves in one launch; train/optim.py (dense_adagrad) takes more
// leaves in more launches.
//
// Arithmetic: optax.scale_by_rss as the plain version
// (train/optim.py, dense_adagrad_reference) computes it, op by op in f32,
// each op rounded on its own (the __f*_rn intrinsics keep nvcc from
// contracting any pair into an FMA):
//   acc = acc + g*g;  rs = acc > 0 ? rsqrtf(acc + 1e-10f) : 0;
//   p = p - (g*rs)*lr
// PyTorch's CUDA rsqrt calls the same rsqrtf, so the kernel gives the plain
// version's bits on the card.
//
// What bounds it: bytes.  An element reads p, g and acc and writes p and
// acc, 20 bytes for 5 flops.  At the MLPerf towers' 2,368,897 f32
// parameters that is 47.4 MB, 14.1 us at 3.35 TB/s.  The plain version
// moves about 90 bytes an element (each op's output written and read
// back).
//
// Design.  The C entry takes the leaves' pointers and lengths and packs
// them, with each leaf's first chunk and whether it takes 16-byte units,
// into one struct passed by value, in the kernel's parameter space: no
// pointer table is copied to the card, nothing is allocated, nothing syncs.
// Each leaf is cut into chunks of kChunk elements; block b takes chunk b of
// the launch and finds its leaf by scanning the chunk starts.  Where a
// leaf's three pointers are 16-byte aligned, a thread issues all of its
// kUnroll 16-byte loads of g, acc and p before any arithmetic, so every
// block keeps 48 KB in flight; a leaf's last n % 4 elements, and every
// element of an unaligned leaf (a view into one flat gradient buffer at an
// odd offset, as the sharded step's all-reduced gradient can give), go
// element by element.  On an H100 80GB HBM3 (700 W) this reads 22-23 us for
// the towers' leaves after an L2 flush, 63-64% of the bound and faster than
// a copy of the same bytes; 1 to 8 units a thread time alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Leaves a launch (train/optim.py groups leaves by MAX_LEAVES, its
// mirror); threads a block; 16-byte units a thread; elements a block.
constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll * 4;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* acc[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];  // first_chunk[count]: the grid
  unsigned long long vec;           // bit i: leaf i's pointers are 16-byte
                                    // aligned; it moves 16-byte units
  int count;
};

__device__ __forceinline__ void adagrad(float& p, float& acc, float g,
                                        float lr) {
  acc = __fadd_rn(acc, __fmul_rn(g, g));
  const float rs = acc > 0.f ? rsqrtf(__fadd_rn(acc, 1e-10f)) : 0.f;
  p = __fsub_rn(p, __fmul_rn(__fmul_rn(g, rs), lr));
}

__device__ __forceinline__ void adagrad4(float4& p, float4& acc,
                                         const float4& g, float lr) {
  adagrad(p.x, acc.x, g.x, lr);
  adagrad(p.y, acc.y, g.y, lr);
  adagrad(p.z, acc.z, g.z, lr);
  adagrad(p.w, acc.w, g.w, lr);
}

__global__ void __launch_bounds__(kThreads)
dense_adagrad_kernel(const Leaves leaves, float lr) {
  const int chunk = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < leaves.count && leaves.first_chunk[leaf + 1] <= chunk) {
    ++leaf;
  }
  const long long n = leaves.n[leaf];
  const long long start =
      static_cast<long long>(chunk - leaves.first_chunk[leaf]) * kChunk;
  const long long end = min(start + kChunk, n);
  float* __restrict__ p = leaves.p[leaf];
  const float* __restrict__ g = leaves.g[leaf];
  float* __restrict__ acc = leaves.acc[leaf];
  long long tail = start;
  if ((leaves.vec >> leaf) & 1ull) {
    const int units = static_cast<int>((end - start) >> 2);
    float4* __restrict__ p4 = reinterpret_cast<float4*>(p + start);
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g + start);
    float4* __restrict__ a4 = reinterpret_cast<float4*>(acc + start);
    float4 gv[kUnroll], av[kUnroll], pv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = threadIdx.x + k * kThreads;
      if (u < units) {
        gv[k] = g4[u];
        av[k] = a4[u];
        pv[k] = p4[u];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = threadIdx.x + k * kThreads;
      if (u < units) {
        adagrad4(pv[k], av[k], gv[k], lr);
        a4[u] = av[k];
        p4[u] = pv[k];
      }
    }
    tail = start + 4ll * units;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pi = p[i], ai = acc[i];
    adagrad(pi, ai, g[i], lr);
    acc[i] = ai;
    p[i] = pi;
  }
}

}  // namespace

extern "C" {

// One launch over `count` leaves (1 to kMaxLeaves, each of n[i] >= 1 f32
// elements).  ptrs holds 3 * count device pointers: the parameters, then
// the gradients, then the accumulators, leaf i at i, count + i and
// 2 * count + i.  Returns cudaErrorInvalidValue for leaves this kernel does
// not take (a count out of range, an empty leaf, a pointer off a float's
// alignment) before anything launches, else the launch's CUDA error.
int dense_adagrad(void* const* ptrs, const long long* n, int count,
                  float lr, void* stream) {
  if (count < 1 || count > kMaxLeaves) {
    return cudaErrorInvalidValue;
  }
  Leaves leaves = {};
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    void* const p = ptrs[i];
    void* const g = ptrs[count + i];
    void* const acc = ptrs[2 * count + i];
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                           reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(acc);
    if (n[i] < 1 || (bits & 3) != 0) {
      return cudaErrorInvalidValue;
    }
    leaves.p[i] = static_cast<float*>(p);
    leaves.g[i] = static_cast<const float*>(g);
    leaves.acc[i] = static_cast<float*>(acc);
    leaves.n[i] = n[i];
    leaves.first_chunk[i] = static_cast<int>(blocks);
    if ((bits & 15) == 0) {
      leaves.vec |= 1ull << i;
    }
    blocks += (n[i] + kChunk - 1) / kChunk;
    if (blocks > 0x7fffffff) {  // the grid's x limit
      return cudaErrorInvalidValue;
    }
  }
  leaves.first_chunk[count] = static_cast<int>(blocks);
  leaves.count = count;
  dense_adagrad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(leaves, lr);
  return cudaGetLastError();
}

}  // extern "C"
