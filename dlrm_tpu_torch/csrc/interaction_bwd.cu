// Fused DLRM dot-interaction backward for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrm_tpu/ops/interaction_pallas.py::_bwd_kernel.
// T (B, F, D) arrives as the forward's two sources: the dense row x (B, D)
// and the feature rows feats (B, F-1, D), each with its own base pointer
// and per-sample stride (the stacked form passes the views T[:, 0] and
// T[:, 1:]).  Given the cotangent g (B, W) of the forward's output row
// [T[b,0,:] | Z[b,i,j] for i > j | zero padding up to W], it writes
//
//   dT[b] = S[b] T[b],  S = dZ + dZ^T,  dZ strictly lower, from g[b, D:D+P]
//   dT[b, 0, :] += g[b, :D]
//
// with dT's row 0 going to dx (B, D) and its rows 1.. to dfeats (B, F-1, D),
// again each through its own pointer and stride (one dT through the same
// two views in the stacked form).  Sums in f32, stored in T's dtype (f32 or
// bf16; g has T's dtype and is read as f32).  The padding columns
// g[b, D+P:] are never read.
//
// What bounds it: bytes.  At the Kaggle fs=128 shape (F=27, D=128, P=351)
// one f32 sample reads 13,824 B of T and 1,916 B of g and writes 13,824 B of
// dT for 93,312 FMAs, about 3 FMAs per byte, far below the card's balance
// point; at Terabyte's D=32 the bytes shrink four times and S's F x F
// entries do not.  The kernel reads x, feats and g once and writes dx and
// dfeats once; S never reaches device memory.  The design keeps the SM's
// own work (the FMAs, the shared-memory reads that feed them, building S)
// short and hides it under the copies:
//   * a persistent grid (as many blocks as the SMs hold at once: in f32 two
//     an SM at D=128, where registers bound it, four at D=32) walks over
//     groups of G consecutive samples (G=2 at D=128, 4 at D=32).  Thread 0 fills a ring of stages
//     with bulk asynchronous copies (cp.async.bulk, completion counted in
//     bytes on one mbarrier a stage): a sample's x row and its F-1 feature
//     rows as its F rows of T, and the group's g rows.  The next groups'
//     copies are in flight while a group is multiplied and stored;
//   * g is staged as it lies.  Where its rows hold no padding (W = D+P, the
//     main path) the group's rows are one contiguous run, else each sample's
//     D+P used columns are a run.  A run is copied in place at its offset
//     modulo 16 bytes: the 16-byte-aligned inside of the run by one bulk
//     copy, the unaligned head and tail (under 16 bytes each) by plain
//     loads, so that nothing outside the run (no padding column), and
//     nothing outside g (a view may start anywhere in its storage), is
//     read.  (Rounding the copy out into the neighbouring samples'
//     columns, which are g's too, ran slower in f32 on an H100);
//   * S is built in shared memory from the staged g: the P pair values are
//     read in order (consecutive threads, consecutive elements) and each is
//     written to its two places in S through a table of destinations made
//     once a block.  The diagonal and the padding of S are zeroed once a
//     block and never written again.  Every g byte crosses HBM once;
//   * a lane owns a 9 x 4 register tile of dT (rows 9rb..9rb+8, columns
//     4c..4c+3) and sums over j: one read of T[j, 4c:4c+4] (16 bytes in
//     f32, 8 in bf16) and three 16-byte broadcast reads of S's nine entries
//     for its rows feed 36 FMAs.  F=27 is three row blocks exactly.  S is
//     laid out j-major, each row block's nine entries padded to 12 floats.
//     A sample is 3 x D/4 items (96 at D=128, 24 at D=32), and the block
//     has a thread for each item of its group, rounded to whole warps, so
//     one pass covers the group at both widths;
//   * each lane stores its tile straight to dx or dfeats, 16 bytes (f32)
//     or 8 bytes (bf16) a row where D is a multiple of 4: neighbouring
//     lanes write neighbouring columns, so the stores are coalesced.
// Rows of T whose byte length or placement is not a multiple of 16 cannot
// be bulk-copied: the same kernel then stages T and g with plain loads,
// into the same places.  The ragged last group is masked; no padding of B
// is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRows = 9;          // rows of dT a lane holds
constexpr int kSRow = 12;         // floats of S a row block takes for one j
constexpr int kChunk = 4;         // columns of dT a lane holds
constexpr int kBarrierBytes = 64; // room for up to 8 mbarriers
constexpr int kMaxStages = kBarrierBytes / 8;
constexpr int kMaxGroup = 32;     // samples a stage holds at most

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float to_f(float x) { return x; }
  __device__ static void store4(float* dst, float4 v) {
    *reinterpret_cast<float4*>(dst) = v;
  }
  __device__ static void store1(float* dst, float v) { *dst = v; }
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
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static uint32_t bits(__nv_bfloat162 h) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16);
  }
  __device__ static void store4(__nv_bfloat16* dst, float4 v) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)),
                   bits(__floats2bfloat162_rn(v.z, v.w)));
  }
  __device__ static void store1(__nv_bfloat16* dst, float v) {
    *dst = __float2bfloat16(v);
  }
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Where everything lies in shared memory, in bytes: the mbarriers; the
// stages, each G samples' T rows at a pitch of `pitch` elements and then
// the group's g area (a slot of D+P elements rounded up to 16 bytes, plus
// 16 for the run's offset, a sample); S for G samples; the pair table; the
// samples' g offsets.  The wrapper (_bwd_smem) mirrors it.
struct Layout {
  int nrb;          // row blocks of kRows rows: ceil(F / 9)
  int nchunks;      // column chunks of kChunk columns: ceil(D / 4)
  int items;        // items a sample: nrb * nchunks
  int gu;           // used columns of g: D + P
  int pairs;        // P
  int t_bytes;      // one sample's T rows in a stage
  int slot_bytes;   // one sample's share of a stage's g area
  int stage_bytes;
  int s_row;        // floats of S for one j: nrb * kSRow
  int s_floats;     // floats of S a sample: F * s_row
  int s_off, pair_off, gofs_off, total;
};

__host__ __device__ inline Layout make_layout(int f, int d, int pitch,
                                              int group, int stages,
                                              int esize) {
  Layout l;
  l.nrb = (f + kRows - 1) / kRows;
  l.nchunks = (d + kChunk - 1) / kChunk;
  l.items = l.nrb * l.nchunks;
  l.pairs = f * (f - 1) / 2;
  l.gu = d + l.pairs;
  l.t_bytes = f * pitch * esize;
  l.slot_bytes = round_up(l.gu * esize, 16) + 16;
  l.stage_bytes = group * (l.t_bytes + l.slot_bytes);
  l.s_row = l.nrb * kSRow;
  l.s_floats = f * l.s_row;
  l.s_off = kBarrierBytes + stages * l.stage_bytes;
  l.pair_off = l.s_off + group * l.s_floats * 4;
  l.gofs_off = l.pair_off + round_up(l.pairs * 4, 16);
  l.total = l.gofs_off + kMaxGroup * 4;
  return l;
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

__device__ __forceinline__ void fma4(float* acc, float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// Row r of sample b of T (or of dT): x[b] for r = 0, else feats[b, r-1].
template <typename P>
__device__ __forceinline__ P* row_of(P* x, long long sx, P* feats,
                                     long long sf, long long b, int r, int d) {
  return r == 0 ? x + b * sx
                : feats + b * sf + static_cast<long long>(r - 1) * d;
}

template <typename T>
struct Args {
  const T* g;
  long long width;   // g's row length in elements (its sample stride)
  const T* x;
  long long sx;      // sample strides, in elements
  const T* feats;
  long long sf;
  T* dx;
  long long sdx;
  T* dfeats;
  long long sdf;
  long long batch;
  int f, d, pitch, group, stages;
};

// One run of g that a group stages: bytes [0, bytes) from src, placed at
// byte `dst` of the stage's g area (16-byte aligned there exactly where it
// is in device memory).  Bytes [lo, hi) go by one bulk copy when lo < hi;
// the run's bytes outside them, [0, lo) and [hi, bytes), each under 16
// bytes, by plain loads.
struct Run {
  const unsigned char* src;
  int bytes, dst, lo, hi;
};

// Run r of the group of ns samples from b0: the group's rows when they hold
// no padding (W = D+P: one run), else sample r's D+P used columns.
template <typename T>
__device__ __forceinline__ Run run_of(const Args<T>& a, const Layout& l,
                                      long long b0, int ns, int r) {
  const bool one = a.width == l.gu;
  Run run;
  run.src = reinterpret_cast<const unsigned char*>(
      a.g + (one ? b0 : b0 + r) * a.width);
  run.bytes = (one ? ns : 1) * l.gu * static_cast<int>(sizeof(T));
  const uintptr_t start = reinterpret_cast<uintptr_t>(run.src);
  const uintptr_t end = start + run.bytes;
  const int off = static_cast<int>(start & 15);
  run.dst = (one ? 0 : r * l.slot_bytes) + off;
  const uintptr_t lo = (start + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t hi = end & ~static_cast<uintptr_t>(15);
  if (lo < hi) {
    run.lo = static_cast<int>(static_cast<long long>(lo - start));
    run.hi = static_cast<int>(static_cast<long long>(hi - start));
  } else {  // under 32 bytes with no aligned 16 inside: all plain loads
    run.lo = run.bytes < 16 ? run.bytes : 16;
    run.hi = run.lo;
  }
  return run;
}

// Thread 0: the bulk copies of group grp into a stage.
template <typename T>
__device__ void issue_group(const Args<T>& a, const Layout& l,
                            unsigned char* stage, uint64_t* bar,
                            long long grp) {
  const long long b0 = grp * a.group;
  const long long left = a.batch - b0;
  const int ns = left < a.group ? static_cast<int>(left) : a.group;
  const uint32_t row_bytes = a.d * sizeof(T);
  const int n_runs = a.width == l.gu ? 1 : ns;
  uint32_t tx = static_cast<uint32_t>(ns) * a.f * row_bytes;
  for (int r = 0; r < n_runs; ++r) {
    const Run run = run_of(a, l, b0, ns, r);
    if (run.lo < run.hi) tx += run.hi - run.lo;
  }
  barrier_expect(bar, tx);
  for (int s = 0; s < ns; ++s) {
    unsigned char* dst = stage + s * l.t_bytes;
    bulk_load(dst, a.x + (b0 + s) * a.sx, row_bytes, bar);
    if (a.f > 1) {
      bulk_load(dst + row_bytes, a.feats + (b0 + s) * a.sf,
                (a.f - 1) * row_bytes, bar);
    }
  }
  unsigned char* garea = stage + a.group * l.t_bytes;
  for (int r = 0; r < n_runs; ++r) {
    const Run run = run_of(a, l, b0, ns, r);
    if (run.lo < run.hi) {
      bulk_load(garea + run.dst + run.lo, run.src + run.lo, run.hi - run.lo,
                bar);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
interaction_bwd_kernel(Args<T> a, bool bulk, bool vec_stores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = a.f, d = a.d, pitch = a.pitch;
  const Layout l = make_layout(f, d, pitch, a.group, a.stages, sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + kBarrierBytes;
  float* sym = reinterpret_cast<float*>(smem + l.s_off);
  uint32_t* pair_dst = reinterpret_cast<uint32_t*>(smem + l.pair_off);
  int* gofs = reinterpret_cast<int*>(smem + l.gofs_off);
  const long long n_groups = (a.batch + a.group - 1) / a.group;
  const int threads = blockDim.x;
  const bool one_run = a.width == l.gu;
  // j-steps unrolled: 3 in f32 (about 128 registers: two blocks an SM at
  // D=128, which ran faster on an H100 than three of fewer registers); 1 in
  // bf16, whose half-size copies leave it bound by the SM's own work, which
  // more resident blocks (64 registers) overlap
  constexpr int kUnroll = sizeof(T) == 4 ? 3 : 1;

  // Once a block: S zeroed (its diagonal and padding stay 0), and for pair
  // p = (i, j), i > j, its two places in S: entry (j, i) and entry (i, j),
  // where entry (jj, i) is S[i][jj] at jj * s_row + (i / 9) * 12 + i % 9.
  for (int k = threadIdx.x; k < a.group * l.s_floats; k += threads) {
    sym[k] = 0.0f;
  }
  for (int i = 1 + threadIdx.x; i < f; i += threads) {
    const int at_i = (i / kRows) * kSRow + i % kRows;
    for (int j = 0; j < i; ++j) {
      const int at_j = (j / kRows) * kSRow + j % kRows;
      pair_dst[i * (i - 1) / 2 + j] =
          static_cast<uint32_t>(j * l.s_row + at_i) |
          (static_cast<uint32_t>(i * l.s_row + at_j) << 16);
    }
  }
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) barrier_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < a.stages; ++s) {
      const long long grp = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (grp < n_groups) {
        issue_group(a, l, stages + s * l.stage_bytes, &bars[s], grp);
      }
    }
  }
  __syncthreads();

  for (long long it = 0;; ++it) {
    const long long grp = blockIdx.x + it * gridDim.x;
    if (grp >= n_groups) break;
    const int st = static_cast<int>(it % a.stages);
    const long long b0 = grp * a.group;
    const long long left = a.batch - b0;
    const int ns = left < a.group ? static_cast<int>(left) : a.group;
    const int n_runs = one_run ? 1 : ns;
    unsigned char* stage = stages + st * l.stage_bytes;
    const T* trows = reinterpret_cast<const T*>(stage);
    unsigned char* garea = stage + a.group * l.t_bytes;

    // 1. The group's T rows and g runs in the stage.
    if (bulk) {
      barrier_wait(&bars[st], static_cast<uint32_t>((it / a.stages) & 1));
      constexpr int kV = 16 / sizeof(T);  // elements a 16-byte piece
      for (int k = threadIdx.x; k < n_runs * 2 * kV; k += threads) {
        const int r = k / (2 * kV);
        const int h = k - r * 2 * kV;
        const Run run = run_of(a, l, b0, ns, r);
        const int pos = h < kV ? h * static_cast<int>(sizeof(T))
                               : run.hi + (h - kV) * static_cast<int>(
                                                         sizeof(T));
        if (pos < (h < kV ? run.lo : run.bytes)) {
          *reinterpret_cast<T*>(garea + run.dst + pos) =
              *reinterpret_cast<const T*>(run.src + pos);
        }
      }
    } else {
      T* rows = reinterpret_cast<T*>(stage);
      for (int k = threadIdx.x; k < ns * f * d; k += threads) {
        const int row = k / d;
        const int c = k - row * d;
        const int s = row / f;
        rows[row * pitch + c] =
            row_of(a.x, a.sx, a.feats, a.sf, b0 + s, row - s * f, d)[c];
      }
      const int run_elems = (one_run ? ns : 1) * l.gu;
      for (int k = threadIdx.x; k < n_runs * run_elems; k += threads) {
        const int r = k / run_elems;
        const int e = k - r * run_elems;
        const Run run = run_of(a, l, b0, ns, r);
        *reinterpret_cast<T*>(garea + run.dst + e * sizeof(T)) =
            reinterpret_cast<const T*>(run.src)[e];
      }
    }
    if (threadIdx.x < ns) {  // where sample s's g row starts in the area
      const int s = threadIdx.x;
      gofs[s] = one_run ? run_of(a, l, b0, ns, 0).dst +
                              s * l.gu * static_cast<int>(sizeof(T))
                        : run_of(a, l, b0, ns, s).dst;
    }
    __syncthreads();

    // 2. S from the staged pair values, both places of each.
    {
      int s = 0, p = threadIdx.x;
      while (p >= l.pairs && s < ns) {
        p -= l.pairs;
        ++s;
      }
      while (s < ns) {
        const T* gs = reinterpret_cast<const T*>(garea + gofs[s]);
        const float v = Elem<T>::to_f(gs[d + p]);
        const uint32_t at = pair_dst[p];
        float* ss = sym + s * l.s_floats;
        ss[at & 0xffffu] = v;
        ss[at >> 16] = v;
        p += threads;
        while (p >= l.pairs && s < ns) {
          p -= l.pairs;
          ++s;
        }
      }
    }
    __syncthreads();

    // 3. 9x4 tiles of dT: item = (sample, row block, column chunk), column
    //    chunk fastest, so that a warp's T reads and stores are contiguous
    //    and its S reads broadcast.
    const int items = ns * l.items;
    for (int item = threadIdx.x; item < items; item += threads) {
      const int s = item / l.items;
      const int rest = item - s * l.items;
      const int rb = rest / l.nchunks;
      const int c = rest - rb * l.nchunks;
      const T* tp = trows + s * f * pitch + kChunk * c;
      const float* sp = sym + s * l.s_floats + rb * kSRow;
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
      }
#pragma unroll(kUnroll)
      for (int j = 0; j < f; ++j) {
        const float4 t = Elem<T>::load4(tp + j * pitch);
        const float* sj = sp + j * l.s_row;
        const float4 s0 = *reinterpret_cast<const float4*>(sj);
        const float4 s1 = *reinterpret_cast<const float4*>(sj + 4);
        const float s8 = sj[8];
        fma4(acc[0], s0.x, t);
        fma4(acc[1], s0.y, t);
        fma4(acc[2], s0.z, t);
        fma4(acc[3], s0.w, t);
        fma4(acc[4], s1.x, t);
        fma4(acc[5], s1.y, t);
        fma4(acc[6], s1.z, t);
        fma4(acc[7], s1.w, t);
        fma4(acc[8], s8, t);
      }
      const long long bi = b0 + s;
      const int k0 = kChunk * c;
      if (rb == 0) {  // row 0 also carries the forward's copy of T[b, 0, :]
        const T* g0 = reinterpret_cast<const T*>(garea + gofs[s]) + k0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (k0 + q < d) acc[0][q] += Elem<T>::to_f(g0[q]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = rb * kRows + r;
        if (i >= f) break;
        T* out = row_of(a.dx, a.sdx, a.dfeats, a.sdf, bi, i, d) + k0;
        if (vec_stores) {  // d % 4 == 0: the whole chunk lies in the row
          Elem<T>::store4(out, make_float4(acc[r][0], acc[r][1], acc[r][2],
                                           acc[r][3]));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (k0 + q < d) Elem<T>::store1(out + q, acc[r][q]);
          }
        }
      }
    }
    if (bulk) {  // this thread's plain stores to the stage come before the
                 // bulk copies that will overwrite it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();  // the stage, S and the offsets are free again

    if (bulk && threadIdx.x == 0) {
      const long long next = grp + static_cast<long long>(a.stages) * gridDim.x;
      if (next < n_groups) issue_group(a, l, stage, &bars[st], next);
    }
  }
}

// Lets the kernel take `smem` bytes of dynamic shared memory, and asks for
// as much shared memory as the SM has, so that several blocks fit.
template <typename T>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 0;  // the largest size set so far (per kernel)
  if (smem <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      interaction_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(interaction_bwd_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// per_sm == nullptr: launch; else: how many blocks of this geometry an SM
// holds at once, into *per_sm.
template <typename T>
int dispatch(const Args<T>& a, int threads, int blocks, int bulk,
             int vec_stores, cudaStream_t stream, int* per_sm) {
  if (a.stages < 1 || a.stages > kMaxStages || a.group < 1 ||
      a.group > kMaxGroup || a.f < 1 || a.d < 1 || a.pitch < a.d ||
      a.pitch % kChunk != 0 || (a.pitch * sizeof(T)) % 16 != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout l =
      make_layout(a.f, a.d, a.pitch, a.group, a.stages, sizeof(T));
  if (l.s_floats >= (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(l.total);
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, interaction_bwd_kernel<T>, threads, smem));
  }
  interaction_bwd_kernel<T><<<blocks, threads, smem, stream>>>(
      a, bulk != 0, vec_stores != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(const void* g, long long width, const void* x, long long sx,
                  const void* feats, long long sf, void* dx, long long sdx,
                  void* dfeats, long long sdf, long long batch, int f, int d,
                  int pitch, int group, int stages) {
  return Args<T>{static_cast<const T*>(g), width, static_cast<const T*>(x),
                 sx, static_cast<const T*>(feats), sf, static_cast<T*>(dx),
                 sdx, static_cast<T*>(dfeats), sdf, batch, f, d, pitch, group,
                 stages};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, x, feats, dx and dfeats all of it).
// width: g's row length (its sample stride) in elements, at least D + P; g
// is otherwise contiguous.  sx, sf, sdx, sdf: sample strides in elements;
// the rows inside a sample are contiguous.  pitch: the shared-memory row
// pitch of T in elements (D when bulk, else D rounded up to 16 bytes).
// group: samples a stage (1..32); stages: 1..8; threads: a multiple of 32
// up to 256; blocks: the persistent grid.  bulk: every row of x and feats
// is 16-byte aligned and a 16-byte multiple, so the stages are filled by
// bulk asynchronous copies.  vec_stores: every row of dx and dfeats is
// aligned to 4 elements and D is a multiple of 4.  Returns 0 or the
// cudaError_t of the launch.  The Python wrapper
// (dlrm_tpu_torch/ops/interaction_fused.py) checks every argument and picks
// the geometry.
extern "C" int interaction_bwd(const void* g, long long width, const void* x,
                               long long sx, const void* feats, long long sf,
                               void* dx, long long sdx, void* dfeats,
                               long long sdf, int dtype, long long batch,
                               int f, int d, int pitch, int group, int stages,
                               int threads, int blocks, int bulk,
                               int vec_stores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(
        make_args<float>(g, width, x, sx, feats, sf, dx, sdx, dfeats, sdf,
                         batch, f, d, pitch, group, stages),
        threads, blocks, bulk, vec_stores, s, nullptr);
  }
  return dispatch<__nv_bfloat16>(
      make_args<__nv_bfloat16>(g, width, x, sx, feats, sf, dx, sdx, dfeats,
                               sdf, batch, f, d, pitch, group, stages),
      threads, blocks, bulk, vec_stores, s, nullptr);
}

// How many blocks of the geometry (dtype, f, d, pitch, group, stages,
// threads) one SM holds at once, into *per_sm (registers and shared memory
// both counted).  Returns 0 or a cudaError_t.
extern "C" int interaction_bwd_blocks_per_sm(int dtype, int f, int d,
                                             int pitch, int group, int stages,
                                             int threads, int* per_sm) {
  if (dtype == 0) {
    return dispatch<float>(
        make_args<float>(nullptr, 0, nullptr, 0, nullptr, 0, nullptr, 0,
                         nullptr, 0, 0, f, d, pitch, group, stages),
        threads, 0, 0, 0, nullptr, per_sm);
  }
  return dispatch<__nv_bfloat16>(
      make_args<__nv_bfloat16>(nullptr, 0, nullptr, 0, nullptr, 0, nullptr,
                               0, nullptr, 0, 0, f, d, pitch, group, stages),
      threads, 0, 0, 0, nullptr, per_sm);
}
