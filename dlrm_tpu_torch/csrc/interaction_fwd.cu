// Fused DLRM dot-interaction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrm_tpu/ops/interaction_pallas.py::_fwd_kernel.
// The interaction input T (B, F, D) arrives as two sources: the dense row
// x (B, D) and the feature rows feats (B, F-1, D), each with its own base
// pointer and per-sample stride; the rows inside a sample are contiguous.
// (The stacked form T passes the two views T[:, 0] and T[:, 1:].)  For every
// sample b it writes one output row
//
//   out[b] = [ x[b] | Z[b,i,j] for i > j in order (1,0),(2,0),(2,1),(3,0)...
//            | zeros up to W ]
//
// where Z = T[b] T[b]^T is accumulated in f32 and the row is written in T's
// dtype (f32 or bf16).  Neither T nor Z ever reaches device memory.
//
// What bounds it: bytes.  At the Kaggle fs=128 shape (F=27, D=128, P=351)
// one f32 sample reads 13,824 B and writes 1,916 B for 44,928 multiply-adds,
// about 3 per byte, far below the H100's balance point.  The kernel reads
// every input byte once and writes every output byte once.  What stands
// between it and the HBM rate is the work inside the SM: the f32 products
// and, above all, the shared-memory reads that feed them (one 16-byte read
// feeds 3.5 products here).  The design overlaps that work with the copies
// and keeps it small:
//   * a persistent grid (as many blocks as the SMs hold at once: three an
//     SM at F=27, D=128) walks over groups of G consecutive samples (G=2
//     there).  Thread 0 fills a ring of two shared-memory stages with bulk
//     asynchronous copies (cp.async.bulk, completion counted in bytes on
//     one mbarrier a stage): one copy of the sample's x row and one of its
//     F-1 feature rows, laid out as the sample's F rows of T in the raw
//     input dtype.  The copies of the next group are in flight while a
//     group is multiplied and stored, and the other blocks of the SM fill
//     one another's barriers;
//   * the lower triangle of Z is cut into 7x7 tiles (rows 0..27 at F=27,
//     one row of padding; 8x8 tiles would pad five).  A work item is
//     either an off-diagonal tile (6 at F=27) or a pair of diagonal tiles
//     (2 at F=27), whose strictly-lower products fill the two triangles of
//     one 7x7 accumulator: every item reads 14 rows and makes 49 or 42
//     products, so the warps do equal work.  8 lanes
//     share an item: lane l sums over the 4-element column chunks l, l+8,
//     l+16, ..., so the 8 lanes of a quarter-warp read 8 consecutive chunks
//     of one row, which fall in 8 different bank groups of the unpadded
//     512-byte rows.  Values are widened to f32 at the read.  A
//     reduce-scatter over the 8 lanes (three shuffle levels, each lane
//     sending half of what it holds) leaves each lane 8 of the sums.  Rows
//     of at most 4 chunks (D=16 in f32) share an item among 4 lanes and
//     two levels, so that no lane idles and the reduction, which does not
//     shrink with D, costs half as much;
//   * a block has one warp for every four items of its group (128 threads
//     for 2 samples at F=27), so one pass covers the group;
//   * the output rows are written from shared memory: the x row and the
//     zero padding as soon as the stage has landed, the pairs from a
//     double-buffered f32 staging area after the block's one barrier a
//     group, with consecutive threads on consecutive elements.
// Rows whose byte length or placement is not a multiple of 16 cannot be
// bulk-copied: the same kernel then stages them with plain loads, at a row
// pitch padded with zeros to 16 bytes, one group at a time.  The ragged
// last group is masked; no padding of B is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTile = 7;                   // a tile is 7x7 entries of Z
constexpr int kAcc = 64;                   // accumulators a lane: 49 used
constexpr int kBarrierBytes = 64;          // room for up to 8 mbarriers
constexpr int kMaxStages = kBarrierBytes / 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float from_f(float x) { return x; }
  __device__ static float zero() { return 0.0f; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float2 pair(uint32_t w) {
    __nv_bfloat162 h;
    h.x = __ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu));
    h.y = __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16));
    return __bfloat1622float2(h);
  }
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = pair(v.x), b = pair(v.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16(0.0f); }
};

// Elements of one stage: G samples of F rows, then the rows that the last
// sample's last tile reads past its F rows (their products are dropped).
__host__ __device__ __forceinline__ long long stage_elems(int f, int pitch,
                                                          int group) {
  const int padded = (f + kTile - 1) / kTile * kTile;
  return static_cast<long long>(group * f + padded - f) * pitch;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// An off-diagonal tile: rows r0..r0+6 against rows c0..c0+6 of one sample,
// product (r, c) in acc[r*7 + c].
template <typename T, int L>
__device__ __forceinline__ void tile_off(const T* smp, int pitch, int r0,
                                         int c0, int q0, int nq,
                                         float (&acc)[kAcc]) {
  const T* pa = smp + r0 * pitch;
  const T* pb = smp + c0 * pitch;
  for (int q = q0; q < nq; q += L) {
    float4 a[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      a[r] = Elem<T>::load4(pa + r * pitch + 4 * q);
    }
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const float4 b = Elem<T>::load4(pb + c * pitch + 4 * q);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        acc[r * kTile + c] = dot4(a[r], b, acc[r * kTile + c]);
      }
    }
  }
}

// The products below the diagonal of the 7 rows at p, (r, c) with c < r,
// into acc[r*7 + c] (kLower) or acc[c*7 + r].
template <typename T, bool kLower>
__device__ __forceinline__ void triangle(const T* p, int pitch, int q,
                                         float (&acc)[kAcc]) {
  float4 a[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) a[r] = Elem<T>::load4(p + r * pitch + 4 * q);
#pragma unroll
  for (int r = 1; r < kTile; ++r) {
#pragma unroll
    for (int c = 0; c < r; ++c) {
      const int i = kLower ? r * kTile + c : c * kTile + r;
      acc[i] = dot4(a[r], a[c], acc[i]);
    }
  }
}

// Two diagonal tiles: rows r0..r0+6 into the lower triangle of acc, rows
// r1..r1+6 into the upper one.  Without `two` the upper triangle repeats
// the lower and is dropped by the caller.
template <typename T, int L>
__device__ __forceinline__ void tile_diag2(const T* smp, int pitch, int r0,
                                           int r1, bool two, int q0, int nq,
                                           float (&acc)[kAcc]) {
  const T* p0 = smp + r0 * pitch;
  const T* p1 = smp + (two ? r1 : r0) * pitch;
  for (int q = q0; q < nq; q += L) {
    triangle<T, true>(p0, pitch, q, acc);
    triangle<T, false>(p1, pitch, q, acc);
  }
}

// One level of the L lanes' reduce-scatter: a lane keeps the half of
// v[0..2*kHalf) on its side of lane bit kHalf*L/64 and adds its partner's
// copy of that half, which the partner sends.
template <int L, int kHalf>
__device__ __forceinline__ void fold(float (&v)[kAcc], int lane) {
  constexpr int kBit = kHalf * L / kAcc;
  const bool upper = (lane & kBit) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kBit);
  }
}

// Sum the L lanes' partial accumulators (L = 4 or 8): after log2(L) levels
// lane l holds the sums of entries (64/L)*l .. (64/L)*l + 64/L - 1 in
// v[0 .. 64/L).
template <int L>
__device__ __forceinline__ void reduce_scatter(float (&v)[kAcc], int lane) {
  fold<L, 32>(v, lane);
  fold<L, 16>(v, lane);
  if constexpr (L == 8) fold<L, 8>(v, lane);
}

template <typename T>
struct Args {
  const T* x;
  long long sx;      // x's sample stride, in elements
  const T* feats;
  long long sf;      // feats' sample stride, in elements
  T* out;            // (batch, width), contiguous
  long long batch;
  int f, d, width;
  int pitch;         // row pitch in shared memory, in elements
  int group;         // samples a stage holds
  int stages;
};

// Thread 0: the bulk copies of group g into stage st.
template <typename T>
__device__ void issue_group(const Args<T>& a, T* stage, uint64_t* bar,
                            long long g) {
  const long long b0 = g * a.group;
  const long long left = a.batch - b0;
  const int ns = left < a.group ? static_cast<int>(left) : a.group;
  const uint32_t row_bytes = a.d * sizeof(T);
  barrier_expect(bar, static_cast<uint32_t>(ns) * a.f * row_bytes);
  for (int s = 0; s < ns; ++s) {
    T* dst = stage + static_cast<long long>(s) * a.f * a.pitch;
    bulk_load(dst, a.x + (b0 + s) * a.sx, row_bytes, bar);
    if (a.f > 1) {
      bulk_load(dst + a.pitch, a.feats + (b0 + s) * a.sf,
                (a.f - 1) * row_bytes, bar);
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(kMaxThreads, 2)
interaction_fwd_kernel(Args<T> a, bool bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* stages = reinterpret_cast<T*>(smem + kBarrierBytes);
  const int f = a.f, d = a.d, pitch = a.pitch;
  const long long per_stage = stage_elems(f, pitch, a.group);
  float* pairs0 = reinterpret_cast<float*>(stages + a.stages * per_stage);
  const int p_count = f * (f - 1) / 2;
  const int nb = (f + kTile - 1) / kTile;
  const int n_off = nb * (nb - 1) / 2;
  const int n_items = n_off + (nb + 1) / 2;
  const int nq = pitch / 4;  // 4-element chunks a row
  const long long n_groups = (a.batch + a.group - 1) / a.group;
  const int threads = blockDim.x;
  const int slots = threads / L;
  const int lane = threadIdx.x % L;
  const int slot = threadIdx.x / L;

  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) barrier_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < a.stages; ++s) {
      const long long g = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (g < n_groups) issue_group(a, stages + s * per_stage, &bars[s], g);
    }
  }
  __syncthreads();

  for (long long it = 0;; ++it) {
    const long long g = blockIdx.x + it * gridDim.x;
    if (g >= n_groups) break;
    const int st = static_cast<int>(it % a.stages);
    const long long b0 = g * a.group;
    const long long left = a.batch - b0;
    const int ns = left < a.group ? static_cast<int>(left) : a.group;
    T* rows = stages + st * per_stage;
    float* pairs = pairs0 + (it & 1) * a.group * p_count;

    if (bulk) {
      barrier_wait(&bars[st], static_cast<uint32_t>((it / a.stages) & 1));
    } else {  // plain loads, zero padding up to the pitch
      const int per_sample = f * pitch;
      for (int k = threadIdx.x; k < ns * per_sample; k += threads) {
        const int s = k / per_sample;
        const int r = (k - s * per_sample) / pitch;
        const int c = k - s * per_sample - r * pitch;
        T v = Elem<T>::zero();
        if (c < d) {
          v = r == 0 ? a.x[(b0 + s) * a.sx + c]
                     : a.feats[(b0 + s) * a.sf + (r - 1) * d + c];
        }
        rows[k] = v;
      }
      __syncthreads();
    }

    // x rows and zero padding of the output rows
    for (int s = 0; s < ns; ++s) {
      T* o = a.out + (b0 + s) * a.width;
      const T* r0 = rows + s * f * pitch;
      for (int c = threadIdx.x; c < d; c += threads) o[c] = r0[c];
      for (int c = d + p_count + threadIdx.x; c < a.width; c += threads) {
        o[c] = Elem<T>::zero();
      }
    }

    // items, item-major over the group's samples: off-diagonal tiles first
    const int items = ns * n_items;
    for (int base = 0; base < items; base += slots) {
      const int item = base + slot;
      const bool valid = item < items;
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
      int s = 0, bi = 0, bj = 0;
      bool two = false;
      if (valid) {
        const int t = item / ns;
        s = item - t * ns;
        const T* smp = rows + s * f * pitch;
        if (t < n_off) {  // (1,0), (2,0), (2,1), (3,0), ...
          int rest = t;
          bi = 1;
          while (rest >= bi) rest -= bi++;
          bj = rest;
          tile_off<T, L>(smp, pitch, bi * kTile, bj * kTile, lane, nq, acc);
        } else {  // diagonal tiles bi and bj = bi + 1
          bi = 2 * (t - n_off);
          bj = bi + 1;
          two = bj < nb;
          tile_diag2<T, L>(smp, pitch, bi * kTile, bj * kTile, two, lane, nq,
                           acc);
        }
      }
      reduce_scatter<L>(acc, lane);
      if (valid) {
        float* dst = pairs + s * p_count;
        const bool off = bj < bi;
#pragma unroll
        for (int k = 0; k < kAcc / L; ++k) {
          const int idx = kAcc / L * lane + k;
          const int r = idx / kTile, c = idx % kTile;
          int i = -1, j = 0;
          if (idx >= kTile * kTile) {
          } else if (off) {
            i = bi * kTile + r;
            j = bj * kTile + c;
          } else if (c < r) {
            i = bi * kTile + r;
            j = bi * kTile + c;
          } else if (c > r && two) {
            i = bj * kTile + c;
            j = bj * kTile + r;
          }
          if (i >= 0 && i < f) dst[i * (i - 1) / 2 + j] = acc[k];
        }
      }
    }
    __syncthreads();  // the stage is read; the pairs are in place

    if (bulk && threadIdx.x == 0) {
      const long long next = g + static_cast<long long>(a.stages) * gridDim.x;
      if (next < n_groups) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_group(a, rows, &bars[st], next);
      }
    }
    for (int s = 0; s < ns; ++s) {
      T* o = a.out + (b0 + s) * a.width + d;
      const float* pr = pairs + s * p_count;
      for (int c = threadIdx.x; c < p_count; c += threads) {
        o[c] = Elem<T>::from_f(pr[c]);
      }
    }
  }
}

template <typename T>
size_t smem_bytes(const Args<T>& a) {
  return kBarrierBytes +
         static_cast<size_t>(a.stages) * stage_elems(a.f, a.pitch, a.group) *
             sizeof(T) +
         static_cast<size_t>(2) * a.group * (a.f * (a.f - 1) / 2) *
             sizeof(float);
}

// Lets the kernel take `smem` bytes of dynamic shared memory, and asks for
// as much shared memory as the SM has, so that several blocks fit.
template <typename T, int L>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 0;  // the largest size set so far (per kernel)
  if (smem <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      interaction_fwd_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(interaction_fwd_kernel<T, L>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <typename T, int L>
int launch(const Args<T>& a, int threads, int blocks, int bulk,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a);
  const cudaError_t err = allow_smem<T, L>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interaction_fwd_kernel<T, L><<<blocks, threads, smem, stream>>>(a,
                                                                 bulk != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int occupancy(const Args<T>& a, int threads, int* per_sm) {
  const size_t smem = smem_bytes<T>(a);
  cudaError_t err = allow_smem<T, L>(smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, interaction_fwd_kernel<T, L>, threads, smem);
  }
  return static_cast<int>(err);
}

// per_sm == nullptr: launch; else: how many blocks of this geometry an SM
// holds at once, into *per_sm.
template <typename T>
int dispatch(const void* x, long long sx, const void* feats, long long sf,
             void* out, long long batch, int f, int d, int width, int pitch,
             int lanes, int group, int stages, int threads, int blocks,
             int bulk, cudaStream_t s, int* per_sm) {
  if (stages < 1 || stages > kMaxStages || pitch % 4 != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (lanes != 4 && lanes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<T> a{static_cast<const T*>(x), sx, static_cast<const T*>(feats),
                  sf, static_cast<T*>(out), batch, f, d, width, pitch, group,
                  stages};
  if (per_sm != nullptr) {
    return lanes == 8 ? occupancy<T, 8>(a, threads, per_sm)
                      : occupancy<T, 4>(a, threads, per_sm);
  }
  return lanes == 8 ? launch<T, 8>(a, threads, blocks, bulk, s)
                    : launch<T, 4>(a, threads, blocks, bulk, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, feats and out all of it).  sx, sf:
// the sample strides of x and feats in elements.  pitch: the shared-memory
// row pitch in elements (D when bulk, else D rounded up to 16 bytes).
// lanes: lanes an item, 8, or 4 for rows of at most 4 chunks of 4 elements.
// group: samples a stage; stages: 1..8; threads: a multiple of 32 up to
// 256; blocks: the persistent grid.  bulk: every row is 16-byte aligned and
// a 16-byte multiple, so the stages are filled by bulk asynchronous copies.
// Returns 0 or the cudaError_t of the launch.  The Python wrapper
// (dlrm_tpu_torch/ops/interaction_fused.py) checks every argument and picks
// the geometry.
extern "C" int interaction_fwd(const void* x, long long sx, const void* feats,
                               long long sf, void* out, int dtype,
                               long long batch, int f, int d, int width,
                               int pitch, int lanes, int group, int stages,
                               int threads, int blocks, int bulk,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(x, sx, feats, sf, out, batch, f, d, width, pitch,
                           lanes, group, stages, threads, blocks, bulk, s,
                           nullptr);
  }
  return dispatch<__nv_bfloat16>(x, sx, feats, sf, out, batch, f, d, width,
                                 pitch, lanes, group, stages, threads, blocks,
                                 bulk, s, nullptr);
}

// How many blocks of the geometry (dtype, f, pitch, lanes, group, stages,
// threads) one SM holds at once, into *per_sm (registers and shared memory
// both counted).  Returns 0 or a cudaError_t.
extern "C" int interaction_fwd_blocks_per_sm(int dtype, int f, int pitch,
                                             int lanes, int group, int stages,
                                             int threads, int* per_sm) {
  if (dtype == 0) {
    return dispatch<float>(nullptr, 0, nullptr, 0, nullptr, 0, f, 0, 0, pitch,
                           lanes, group, stages, threads, 0, 0, nullptr,
                           per_sm);
  }
  return dispatch<__nv_bfloat16>(nullptr, 0, nullptr, 0, nullptr, 0, f, 0, 0,
                                 pitch, lanes, group, stages, threads, 0, 0,
                                 nullptr, per_sm);
}
