// The first design of the fused interaction backward (one-shot grid, a
// block stages its samples synchronously, 4x4 register tiles), kept for
// probes/interaction_bwd_probe.py to time the port's kernel against, in
// turns on one card.  Not part of the package: the kernel that the port
// runs is dlrm_tpu_torch/csrc/interaction_bwd.cu.  Entry point
// probe_bwd_first, with the arguments the package's wrapper gave it.
//
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
// What bounds it: at the Kaggle fs=128 shape (F=27, D=128, P=351) one f32
// sample reads 13,824 B of T and 1,916 B of g and writes 13,824 B of dT for
// 93,312 FMAs, about 3 FMAs per byte: far below the card's balance point,
// so the kernel should be bound by bytes.  It reads x, feats and g once and
// writes dx and dfeats once; S never reaches device memory.  Inside the
// block:
//   * a block takes S consecutive samples (the caller picks S so that the
//     staging fits in shared memory).  Their T rows are copied into shared
//     memory as f32, with 16-byte loads where the rows allow, at a row
//     stride of D4 = round_up(D, 4) floats.  S is built there straight from
//     g as a dense F x Fp f32 matrix (Fp = round_up(F, 4)), zero on the
//     diagonal and in the columns past F;
//   * each thread owns a 4x4 register tile of dT (rows i0..i0+3, columns
//     k0..k0+3) and sums over j: one 16-byte read of S[j, i0:i0+4] (S is
//     symmetric, so row j holds column j) and one of T[j, k0:k0+4] feed 16
//     FMAs.  Neighbouring lanes take neighbouring column tiles, so the T
//     reads of a warp are contiguous and the S reads broadcast;
//   * a tile adds g[b, k0:k0+4] to row 0 and stores its rows straight to
//     dx or dfeats, 16 bytes (f32) or 8 bytes (bf16) a row where D is a
//     multiple of 4.
// Columns D..D4-1 of the staged T are never written: they feed only output
// columns that are not stored.  The ragged edge (the last block may hold
// fewer than S samples) is masked; no padding of B is needed.

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
  __device__ static void unpack(const uint4& v, float* dst) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                    __uint_as_float(v.z), __uint_as_float(v.w));
  }
  __device__ static void store4(float* dst, float4 v) {
    *reinterpret_cast<float4*>(dst) = v;
  }
  __device__ static void store1(float* dst, float v) { *dst = v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static float2 pair(uint32_t w) {
    __nv_bfloat162 h;
    h.x = __ushort_as_bfloat16(static_cast<unsigned short>(w & 0xffffu));
    h.y = __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16));
    return __bfloat1622float2(h);
  }
  __device__ static void unpack(const uint4& v, float* dst) {
    const float2 a = pair(v.x), b = pair(v.y), c = pair(v.z), d = pair(v.w);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
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

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

// Shared-memory floats one sample takes: its T rows, then its S rows.
__host__ __device__ __forceinline__ int sample_floats(int f, int d) {
  return f * round_up4(d) + f * round_up4(f);
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
struct Rows {
  const T* x;
  long long sx;
  const T* feats;
  long long sf;
  T* dx;
  long long sdx;
  T* dfeats;
  long long sdf;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_first_kernel(const T* __restrict__ g, Rows<T> io, long long batch,
                       int f, int d, int width, int samples_per_block,
                       bool vec_loads, bool vec_stores) {
  extern __shared__ __align__(16) float smem[];
  const int fp = round_up4(f);
  const int d4 = round_up4(d);
  const int t_floats = f * d4;   // one sample's T rows
  const int s_floats = f * fp;   // one sample's S rows
  const long long b0 = static_cast<long long>(blockIdx.x) * samples_per_block;
  const long long left = batch - b0;
  const int ns = left < samples_per_block ? static_cast<int>(left)
                                          : samples_per_block;
  float* rows = smem;                                   // S * t_floats
  float* sym = smem + samples_per_block * t_floats;     // S * s_floats

  // 1. Stage the ns samples' T rows as f32 at stride d4 (row r of sample s
  //    is staged row s * f + r).
  if (vec_loads) {  // every row 16-byte aligned and a 16-byte multiple, so
                    // d4 == d: a sample is x's row, then its feature rows
    constexpr int kVec = Elem<T>::kVec;
    const int per_row = d / kVec;
    for (int s = 0; s < ns; ++s) {
      const uint4* x4 = reinterpret_cast<const uint4*>(io.x + (b0 + s) * io.sx);
      const uint4* f4 = reinterpret_cast<const uint4*>(io.feats +
                                                       (b0 + s) * io.sf) -
                        per_row;
      float* dst = rows + s * t_floats;
      for (int k = threadIdx.x; k < f * per_row; k += blockDim.x) {
        Elem<T>::unpack(__ldg(k < per_row ? x4 + k : f4 + k), dst + k * kVec);
      }
    }
  } else {
    for (int k = threadIdx.x; k < ns * f * d; k += blockDim.x) {
      const int row = k / d;
      const int s = row / f;
      const int c = k - row * d;
      rows[row * d4 + c] = Elem<T>::to_f(
          row_of(io.x, io.sx, io.feats, io.sf, b0 + s, row - s * f, d)[c]);
    }
  }

  // 2. S = dZ + dZ^T: S[j][i] = g[D + hi(hi-1)/2 + lo] for i != j, both < F
  //    (hi, lo = the larger and smaller of i, j); 0 on the diagonal and in
  //    columns F..Fp-1.
  const T* gsrc = g + b0 * width;
  for (int k = threadIdx.x; k < ns * s_floats; k += blockDim.x) {
    const int s = k / s_floats;
    const int r = k - s * s_floats;
    const int j = r / fp;
    const int i = r - j * fp;
    float v = 0.0f;
    if (i < f && i != j) {
      const int hi = i > j ? i : j;
      const int lo = i + j - hi;
      v = Elem<T>::to_f(gsrc[static_cast<long long>(s) * width + d +
                             hi * (hi - 1) / 2 + lo]);
    }
    sym[k] = v;
  }
  __syncthreads();

  // 3. 4x4 tiles of dT: item = (sample, row tile, column tile), column
  //    tile fastest so that a warp's T reads are contiguous.
  const int rows4 = fp / 4;
  const int cols4 = d4 / 4;
  const int items = ns * rows4 * cols4;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int tc = it % cols4;
    const int rest = it / cols4;
    const int ti = rest % rows4;
    const int s = rest / rows4;
    const float* sp = sym + s * s_floats + 4 * ti;
    const float* tp = rows + s * t_floats + 4 * tc;
    float acc[4][4] = {};
#pragma unroll 4
    for (int j = 0; j < f; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(sp + j * fp);
      const float4 b = *reinterpret_cast<const float4*>(tp + j * d4);
      fma4(acc[0], a.x, b);
      fma4(acc[1], a.y, b);
      fma4(acc[2], a.z, b);
      fma4(acc[3], a.w, b);
    }
    const long long bi = b0 + s;
    const int k0 = 4 * tc;
    if (ti == 0) {  // row 0 also carries the forward's copy of T[b, 0, :]
      const T* g0 = g + bi * width + k0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (k0 + q < d) acc[0][q] += Elem<T>::to_f(g0[q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ti + r;
      if (i >= f) break;
      T* out = row_of(io.dx, io.sdx, io.dfeats, io.sdf, bi, i, d) + k0;
      if (vec_stores) {  // d % 4 == 0, so the whole tile lies inside the row
        Elem<T>::store4(out,
                        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (k0 + q < d) Elem<T>::store1(out + q, acc[r][q]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* g, const Rows<T>& io, long long batch, int f, int d,
           int width, int samples_per_block, int vec_loads, int vec_stores,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(samples_per_block) *
                      sample_floats(f, d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_first_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (batch + samples_per_block - 1) / samples_per_block;
  bwd_first_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(
      static_cast<const T*>(g), io, batch, f, d, width, samples_per_block,
      vec_loads != 0, vec_stores != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* g, const void* x, long long sx, const void* feats,
             long long sf, void* dx, long long sdx, void* dfeats,
             long long sdf, long long batch, int f, int d, int width,
             int samples_per_block, int vec_loads, int vec_stores,
             cudaStream_t s) {
  const Rows<T> io{static_cast<const T*>(x), sx, static_cast<const T*>(feats),
                   sf, static_cast<T*>(dx), sdx, static_cast<T*>(dfeats), sdf};
  return launch<T>(g, io, batch, f, d, width, samples_per_block, vec_loads,
                   vec_stores, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, x, feats, dx and dfeats all of it).
// sx, sf, sdx, sdf: sample strides in elements; the rows inside a sample
// are contiguous.  vec_loads: every row of x and feats is 16-byte aligned
// and D * sizeof(T) is a multiple of 16.  vec_stores: every row of dx and
// dfeats is aligned to 4 elements and D is a multiple of 4.  Returns 0 or
// the cudaError_t of the launch.  The Python wrapper
// (dlrm_tpu_torch/ops/interaction_fused.py) checks every argument and picks
// the geometry.
extern "C" int probe_bwd_first(const void* g, const void* x, long long sx,
                               const void* feats, long long sf, void* dx,
                               long long sdx, void* dfeats, long long sdf,
                               int dtype, long long batch, int f, int d,
                               int width, int samples_per_block,
                               int vec_loads, int vec_stores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(g, x, sx, feats, sf, dx, sdx, dfeats, sdf, batch,
                           f, d, width, samples_per_block, vec_loads,
                           vec_stores, s);
  }
  return dispatch<__nv_bfloat16>(g, x, sx, feats, sf, dx, sdx, dfeats, sdf,
                                 batch, f, d, width, samples_per_block,
                                 vec_loads, vec_stores, s);
}
