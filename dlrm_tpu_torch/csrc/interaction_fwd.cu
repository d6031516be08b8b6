// Fused DLRM dot-interaction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrm_tpu/ops/interaction_pallas.py::_fwd_kernel.
// For every sample b of T (B, F, D) it writes one output row
//
//   out[b] = [ T[b,0,:] | Z[b,i,j] for i > j in order (1,0),(2,0),(2,1),(3,0)...
//            | zeros up to W ]
//
// where Z = T[b] T[b]^T is accumulated in f32 and the row is cast to T's
// dtype (f32 or bf16).  Z never reaches device memory.
//
// What bounds it: at the Kaggle fs=128 shape (F=27, D=128, P=351) one f32
// sample reads 13,824 B and writes 1,916 B for 89,856 FLOP, about 6 FLOP per
// byte: far below the H100's balance point, so the kernel should be bound by
// bytes.  It reads T once and writes the output once.  Inside the block the
// limit is shared-memory traffic, so the Gram matrix is register-tiled:
//   * a block takes S consecutive samples (chosen by the caller so that the
//     staging fits in shared memory).  Their rows are copied into shared
//     memory as f32 with 16-byte loads where the rows allow it, padded to
//     Fp = round_up(F, 4) rows and D4 = round_up(D, 4) columns with zeros,
//     at a row stride of D4 + 4 floats so that the 16-byte reads of 8
//     neighbouring rows fall in 8 different bank groups;
//   * the lower triangle of Z, diagonal included, is cut into 4x4 tiles
//     (28 tiles at F=27).  A group of K consecutive lanes (K a power of
//     two) takes one tile of one sample; each lane sums over every K-th
//     group of 4 columns, reading a 4x4 block of T for the tile's rows and
//     one for its columns (8 16-byte loads per 64 FMAs), and the K partial
//     tiles are summed with shuffles;
//   * the strictly-lower entries land in shared memory in pair order, and
//     the block then writes its S output rows (contiguous in `out`) with
//     coalesced stores, filling in T[b,0,:] and the zero padding on the way.
// The ragged edge (the last block may have fewer than S samples) is masked;
// no padding of B is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
  __device__ static void unpack(const uint4& v, float4* dst) {
    dst[0] = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                         __uint_as_float(v.z), __uint_as_float(v.w));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
  __device__ static float2 pair(uint32_t w) {
    __nv_bfloat162 h;
    h.x = __ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu));
    h.y = __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16));
    return __bfloat1622float2(h);
  }
  __device__ static void unpack(const uint4& v, float4* dst) {
    float2 a = pair(v.x), b = pair(v.y), c = pair(v.z), d = pair(v.w);
    dst[0] = make_float4(a.x, a.y, b.x, b.y);
    dst[1] = make_float4(c.x, c.y, d.x, d.y);
  }
};

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

// Shared-memory floats one sample takes: its padded rows, then its pairs.
__host__ __device__ __forceinline__ int tile_floats(int f, int d) {
  return round_up4(f) * (round_up4(d) + 4);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
interaction_fwd_kernel(const T* __restrict__ t, T* __restrict__ out,
                       long long batch, int f, int d, int width,
                       int samples_per_block, int kparts, bool vec_loads) {
  extern __shared__ __align__(16) float smem[];
  const int p_count = f * (f - 1) / 2;
  const int fp = round_up4(f);
  const int d4 = round_up4(d);
  const int ds = d4 + 4;                       // row stride in floats
  const int per_sample = tile_floats(f, d);
  const int tile_rows = fp / 4;
  const int n_tiles = tile_rows * (tile_rows + 1) / 2;
  const long long b0 = static_cast<long long>(blockIdx.x) * samples_per_block;
  const long long left = batch - b0;
  const int ns = left < samples_per_block ? static_cast<int>(left)
                                          : samples_per_block;
  float* rows = smem;                                    // S * per_sample
  float* pairs = smem + samples_per_block * per_sample;  // S * P

  // 1. Stage the ns samples as f32 rows at stride ds; zero the padding
  //    that step 2 reads (rows f..fp-1, columns d..d4-1).
  const int pad_rows = fp - f;
  for (int k = threadIdx.x; k < ns * pad_rows * d4; k += blockDim.x) {
    const int s = k / (pad_rows * d4);
    const int r = k - s * pad_rows * d4;
    rows[s * per_sample + (f + r / d4) * ds + r % d4] = 0.0f;
  }
  const int pad_cols = d4 - d;
  for (int k = threadIdx.x; k < ns * f * pad_cols; k += blockDim.x) {
    const int row = k / pad_cols;            // over all ns*f rows
    const int s = row / f;
    rows[s * per_sample + (row - s * f) * ds + d + k % pad_cols] = 0.0f;
  }
  const T* src = t + b0 * f * d;
  if (vec_loads) {  // d * sizeof(T) is a multiple of 16: whole vectors per row
    constexpr int kVec = Elem<T>::kVec;
    const int per_row = d / kVec;
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (int k = threadIdx.x; k < ns * f * per_row; k += blockDim.x) {
      const int row = k / per_row;
      const int s = row / f;
      float* dst = rows + s * per_sample + (row - s * f) * ds +
                   (k - row * per_row) * kVec;
      Elem<T>::unpack(__ldg(src4 + k), reinterpret_cast<float4*>(dst));
    }
  } else {
    for (int k = threadIdx.x; k < ns * f * d; k += blockDim.x) {
      const int row = k / d;
      const int s = row / f;
      rows[s * per_sample + (row - s * f) * ds + (k - row * d)] =
          Elem<T>::to_f(src[k]);
    }
  }
  __syncthreads();

  // 2. 4x4 tiles of Z.  Lane group (kparts consecutive threads) = one
  //    (sample, tile); the loop bound is block-uniform and a group never
  //    straddles a warp, so every lane reaches the shuffles.
  const int chunks = d4 / 4;
  const int items = ns * n_tiles * kparts;
  for (int base = 0; base < items; base += blockDim.x) {
    const int it = base + threadIdx.x;
    const int kh = it % kparts;
    const bool valid = it < items;
    float acc[4][4] = {};
    int s = 0, ti = 0, tj = 0;
    if (valid) {
      const int grp = it / kparts;
      s = grp / n_tiles;
      const int tl = grp - s * n_tiles;  // tiles (0,0),(1,0),(1,1),(2,0)...
      ti = static_cast<int>((sqrtf(8.0f * tl + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > tl) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= tl) ++ti;
      tj = tl - ti * (ti + 1) / 2;
      const float* ra = rows + s * per_sample + 4 * ti * ds;
      const float* rb = rows + s * per_sample + 4 * tj * ds;
      for (int c = kh; c < chunks; c += kparts) {
        float4 a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = *reinterpret_cast<const float4*>(ra + r * ds + 4 * c);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(rb + q * ds + 4 * c);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][q] = dot4(a[r], b, acc[r][q]);
        }
      }
    }
    for (int off = kparts >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], off);
        }
      }
    }
    if (valid && kh == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * ti + r, j = 4 * tj + q;
          if (i < f && j < i) pairs[s * p_count + i * (i - 1) / 2 + j] = acc[r][q];
        }
      }
    }
  }
  __syncthreads();

  // 3. Write the ns output rows, contiguous in `out`.
  T* dst = out + b0 * width;
  for (int k = threadIdx.x; k < ns * width; k += blockDim.x) {
    const int s = k / width;
    const int c = k - s * width;
    float v = 0.0f;
    if (c < d) {
      v = rows[s * per_sample + c];
    } else if (c < d + p_count) {
      v = pairs[s * p_count + (c - d)];
    }
    dst[k] = Elem<T>::from_f(v);
  }
}

template <typename T>
int launch(const void* t, void* out, long long batch, int f, int d, int width,
           int samples_per_block, int kparts, int vec_loads,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(samples_per_block) *
                      (tile_floats(f, d) + f * (f - 1) / 2) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        interaction_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (batch + samples_per_block - 1) / samples_per_block;
  interaction_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
      static_cast<const T*>(t), static_cast<T*>(out), batch, f, d, width,
      samples_per_block, kparts, vec_loads != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kparts: lanes that share one 4x4 tile
// (a power of two, at most 32).  vec_loads: T's base is 16-byte aligned and
// D * sizeof(T) is a multiple of 16.  Returns 0 or the cudaError_t of the
// launch.  The Python wrapper (dlrm_tpu_torch/ops/interaction_fused.py)
// checks every argument and picks the geometry.
extern "C" int interaction_fwd(const void* t, void* out, int dtype,
                               long long batch, int f, int d, int width,
                               int samples_per_block, int kparts,
                               int vec_loads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(t, out, batch, f, d, width, samples_per_block, kparts,
                         vec_loads, s);
  }
  return launch<__nv_bfloat16>(t, out, batch, f, d, width, samples_per_block,
                               kparts, vec_loads, s);
}
