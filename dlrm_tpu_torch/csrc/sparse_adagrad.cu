// The device tables' row-wise Adagrad as one sorted segment sum, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package dedups a step's embedding
// gradient with a fixed-size unique and applies row-wise Adagrad to the
// distinct rows (dlrm_tpu/train/optim.py, the `dedup` implementation), which
// XLA lowers on the TPU.  The port ran it as PyTorch ops: a split of the
// per-hit gradient by table group, `unique` (whose distinct count is read
// back to the host, a sync), an atomic `index_add_` of every hit into a
// zeroed (U, D) buffer, then about ten elementwise launches and two more
// `index_add_`s.  Here the caller sorts the step's stacked ids once
// (`torch.sort(stable=True)`, ops/embedding.py sort_hits: no sync) and this
// file sums each distinct row's hits and applies its update, with the
// distinct count never leaving the card.
//
// Arithmetic: for each distinct row r with hits h (in hit order),
//   g = sum_h grads[h]                      (f32, in sorted order)
//   acc[r] = acc[r] + mean_D(g * g)
//   rs = acc[r] > 0 ? rsqrtf(acc[r] + 1e-10f) : 0
//   emb[r] = emb[r] - (g * rs) * lr
// each op rounded on its own as train/optim.py apply_adagrad_rows rounds it
// (the __f*_rn intrinsics keep nvcc from contracting a pair into an FMA;
// the mean is the sum times the f32 1/D, as PyTorch's mean multiplies).
// Given the same summed row and the same sum of squares, the update is that
// function's to the bit; the order of the row's sum over its hits and of
// the D-term sum of squares differ.
//
// What bounds it: bytes.  The per-hit gradient rows are read once (at the
// Kaggle cell's B=32768 x 26 hits of 512 B, 436 MB), the sorted ids and
// positions once, each distinct row and its accumulator read and written
// once: ~510 MB a step, 0.15 ms at 3.35 TB/s.
//
// Design.  The sorted hits are cut into fixed chunks of kChunk positions,
// one warp a chunk, so a run of 24,000 hits of one row (the Zipf head, the
// 3-row tables) spreads over many warps instead of holding one.  A warp
// walks its chunk in order with the rows of kGroup hits in flight (16-byte
// loads, a lane a 16-byte unit: one warp a 512-byte row at D=128), summing
// each run's hits in f32; the table row and accumulator of a run that
// begins in a group are read with that group's gradient rows, so no update
// waits on a read of its own.  A run that starts and ends inside the chunk
// is applied at once.  A run that crosses a chunk border leaves partial sums:
// the chunk's first run, if it began in an earlier chunk, as the chunk's
// head partial; its last run, if it began in this chunk and goes on into
// the next, as its tail partial.  A second launch gives each crossing run
// to the chunk where it began: that warp finds the run's end (a 32-way
// search over the sorted ids), adds the tail partial and the following
// chunks' head partials in chunk order, and applies the update once.  So
// every row is updated by one warp, nothing is atomic, and the result is
// the same from run to run.  The grid comes from the hit count, which the
// host knows; the distinct count stays on the card.  Ids are checked against
// the table: one out of range traps, as PyTorch's index ops assert on the
// card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads a block; hits a chunk (ops/embedding.py SORTED_CHUNK mirrors it
// to size the partials); hits whose rows a warp loads together.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;
constexpr int kGroup = 4;
constexpr unsigned kFull = 0xffffffffu;

// A lane's part of a row: UPL units of VEC floats, unit lane + 32 * u.
template <int VEC, int UPL>
struct Part {
  float v[UPL * VEC];
};

template <int VEC, int UPL>
__device__ __forceinline__ void zero(Part<VEC, UPL>& p) {
#pragma unroll
  for (int k = 0; k < UPL * VEC; ++k) p.v[k] = 0.f;
}

template <int VEC, int UPL>
__device__ __forceinline__ void load(Part<VEC, UPL>& p,
                                     const float* __restrict__ row, int units,
                                     int lane) {
#pragma unroll
  for (int u = 0; u < UPL; ++u) {
    const int unit = lane + 32 * u;
    if (unit < units) {
      if constexpr (VEC == 4) {
        const float4 x = reinterpret_cast<const float4*>(row)[unit];
        p.v[4 * u] = x.x;
        p.v[4 * u + 1] = x.y;
        p.v[4 * u + 2] = x.z;
        p.v[4 * u + 3] = x.w;
      } else {
        p.v[u] = row[unit];
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) p.v[VEC * u + k] = 0.f;
    }
  }
}

template <int VEC, int UPL>
__device__ __forceinline__ void store(const Part<VEC, UPL>& p,
                                      float* __restrict__ row, int units,
                                      int lane) {
#pragma unroll
  for (int u = 0; u < UPL; ++u) {
    const int unit = lane + 32 * u;
    if (unit < units) {
      if constexpr (VEC == 4) {
        reinterpret_cast<float4*>(row)[unit] =
            make_float4(p.v[4 * u], p.v[4 * u + 1], p.v[4 * u + 2],
                        p.v[4 * u + 3]);
      } else {
        row[unit] = p.v[u];
      }
    }
  }
}

template <int VEC, int UPL>
__device__ __forceinline__ void add(Part<VEC, UPL>& s,
                                    const Part<VEC, UPL>& x) {
#pragma unroll
  for (int k = 0; k < UPL * VEC; ++k) s.v[k] = __fadd_rn(s.v[k], x.v[k]);
}

// The stacked row `row` of the table (every lane its part) and, in lane 0,
// its accumulator, read ahead of its update.  An id off the table traps.
template <int VEC, int UPL>
__device__ __forceinline__ void fetch(long long row, Part<VEC, UPL>& w,
                                      float& a, const float* emb,
                                      const float* acc, long long rows, int d,
                                      int units, int lane) {
  if (row < 0 || row >= rows) {
    __trap();
  }
  load(w, emb + row * d, units, lane);
  a = lane == 0 ? acc[row] : 0.f;
}

// Row-wise Adagrad of the stacked row `row` with its summed gradient g, on
// its row w and accumulator a as fetch() read them (the whole warp).
template <int VEC, int UPL>
__device__ __forceinline__ void apply(long long row, const Part<VEC, UPL>& g,
                                      Part<VEC, UPL>& w, float a,
                                      float* __restrict__ emb,
                                      float* __restrict__ acc, int d,
                                      int units, int lane, float inv_d,
                                      float lr) {
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < UPL * VEC; ++k) {
    sq = __fadd_rn(sq, __fmul_rn(g.v[k], g.v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, off));
  }
  a = __fadd_rn(__shfl_sync(kFull, a, 0), __fmul_rn(sq, inv_d));
  const float rs = a > 0.f ? rsqrtf(__fadd_rn(a, 1e-10f)) : 0.f;
#pragma unroll
  for (int k = 0; k < UPL * VEC; ++k) {
    w.v[k] = __fsub_rn(w.v[k], __fmul_rn(__fmul_rn(g.v[k], rs), lr));
  }
  store(w, emb + row * d, units, lane);
  if (lane == 0) {
    acc[row] = a;
  }
}

struct Args {
  const void* ids;         // (n,) sorted stacked rows, of type Id
  const long long* pos;    // (n,) each sorted hit's row of grads
  const float* grads;      // (hits, d) per hit, in hit order
  float* emb;              // (rows, d)
  float* acc;              // (rows,)
  float* partials;         // (2 * chunks, d): a chunk's head, then tail
  long long n;
  long long rows;
  int d;
  int units;
  float inv_d;
  float lr;
};

// Launch one: every chunk's runs, applied or left as partials.
template <typename Id, int VEC, int UPL>
__global__ void __launch_bounds__(kThreads)
sparse_adagrad_segment_kernel(const Args a) {
  __shared__ Id s_ids[kWarps][kChunk];
  __shared__ long long s_pos[kWarps][kChunk];
  const Id* __restrict__ ids = static_cast<const Id*>(a.ids);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long chunk = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long lo = chunk * kChunk;
  if (lo >= a.n) {
    return;
  }
  const int len = static_cast<int>(min(static_cast<long long>(kChunk),
                                       a.n - lo));
  for (int i = lane; i < len; i += 32) {
    s_ids[warp][i] = ids[lo + i];
    s_pos[warp][i] = a.pos[lo + i];
  }
  __syncwarp();
  // the chunk's first run began in an earlier chunk; its last goes on
  const bool before = lo > 0 && ids[lo - 1] == s_ids[warp][0];
  const bool after = lo + len < a.n && ids[lo + len] == s_ids[warp][len - 1];
  float* const head = a.partials + (2 * chunk) * a.d;
  float* const tail = head + a.d;

  // the running sum of the current run, and its table row and accumulator,
  // read when the run began (with the gradient rows of its group, so that
  // an update waits on no read of its own)
  Part<VEC, UPL> sum, row;
  zero(sum);
  zero(row);
  float racc = 0.f;
  Id cur = s_ids[warp][0];
  if (!before) {
    fetch(static_cast<long long>(cur), row, racc, a.emb, a.acc, a.rows, a.d,
          a.units, lane);
  }
  bool first = true;
  for (int base = 0; base < len; base += kGroup) {
    Part<VEC, UPL> x[kGroup], w[kGroup];
    float wa[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int i = base + j;
      if (i < len) {
        load(x[j], a.grads + s_pos[warp][i] * a.d, a.units, lane);
        if (i > 0 && s_ids[warp][i] != s_ids[warp][i - 1]) {  // a run begins
          fetch(static_cast<long long>(s_ids[warp][i]), w[j], wa[j], a.emb,
                a.acc, a.rows, a.d, a.units, lane);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (base + j < len) {
        const Id id = s_ids[warp][base + j];
        if (id != cur) {  // the run of `cur` ends inside the chunk
          if (first && before) {
            store(sum, head, a.units, lane);
          } else {
            apply(static_cast<long long>(cur), sum, row, racc, a.emb, a.acc,
                  a.d, a.units, lane, a.inv_d, a.lr);
          }
          first = false;
          cur = id;
          zero(sum);
          row = w[j];
          racc = wa[j];
        }
        add(sum, x[j]);
      }
    }
  }
  if (first && before) {
    store(sum, head, a.units, lane);
  } else if (after) {
    store(sum, tail, a.units, lane);
  } else {
    apply(static_cast<long long>(cur), sum, row, racc, a.emb, a.acc, a.d,
          a.units, lane, a.inv_d, a.lr);
  }
}

// Launch two: each run that crosses a chunk border, by the chunk where it
// began: its partials in chunk order, then its update.
template <typename Id, int VEC, int UPL>
__global__ void __launch_bounds__(kThreads)
sparse_adagrad_carry_kernel(const Args a) {
  const Id* __restrict__ ids = static_cast<const Id*>(a.ids);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long chunk = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long lo = chunk * kChunk;
  const long long hi = lo + kChunk;
  if (hi >= a.n) {
    return;
  }
  const Id id = ids[hi - 1];
  if (ids[hi] != id || (lo > 0 && ids[lo - 1] == id)) {
    return;  // no run goes on, or the chunk lies inside an earlier one's
  }
  // the run's end: the first position after hi holding another id (or n),
  // narrowed 32 ways a round; ids[hi] == id
  long long lo_end = hi + 1;
  long long hi_end = a.n;
  while (lo_end < hi_end) {
    const long long step = (hi_end - lo_end + 31) / 32;
    const long long p = lo_end + lane * step;
    const bool same = p < hi_end && ids[p] == id;
    const int k = __popc(__ballot_sync(kFull, same));
    if (k == 0) {
      hi_end = lo_end;
    } else {
      const long long last_same = lo_end + (k - 1) * step;
      lo_end = last_same + 1;
      hi_end = min(hi_end, last_same + step);
    }
  }
  const long long last = (lo_end - 1) / kChunk;  // the run's last chunk
  Part<VEC, UPL> sum;
  load(sum, a.partials + (2 * chunk + 1) * a.d, a.units, lane);
  for (long long c = chunk + 1; c <= last; c += kGroup) {
    Part<VEC, UPL> x[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (c + j <= last) {
        load(x[j], a.partials + (2 * (c + j)) * a.d, a.units, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (c + j <= last) {
        add(sum, x[j]);
      }
    }
  }
  Part<VEC, UPL> row;
  float racc;
  fetch(static_cast<long long>(id), row, racc, a.emb, a.acc, a.rows, a.d,
        a.units, lane);
  apply(static_cast<long long>(id), sum, row, racc, a.emb, a.acc, a.d,
        a.units, lane, a.inv_d, a.lr);
}

template <typename Id, int VEC, int UPL>
int launch(const Args& a, unsigned blocks, cudaStream_t stream) {
  sparse_adagrad_segment_kernel<Id, VEC, UPL>
      <<<blocks, kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  sparse_adagrad_carry_kernel<Id, VEC, UPL>
      <<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename Id, int VEC>
int launch_units(const Args& a, unsigned blocks, cudaStream_t stream) {
  const int upl = (a.units + 31) / 32;
  if (upl <= 1) return launch<Id, VEC, 1>(a, blocks, stream);
  if (upl <= 2) return launch<Id, VEC, 2>(a, blocks, stream);
  if (upl <= 4) return launch<Id, VEC, 4>(a, blocks, stream);
  return cudaErrorInvalidValue;
}

template <typename Id>
int launch_vec(const Args& a, bool vec, unsigned blocks, cudaStream_t stream) {
  return vec ? launch_units<Id, 4>(a, blocks, stream)
             : launch_units<Id, 1>(a, blocks, stream);
}

}  // namespace

extern "C" {

// Row-wise Adagrad of the stacked table over n >= 1 sorted hits, in two
// launches on `stream`.  ids: n stacked rows in ascending order, ties in hit
// order, of id_bytes 4 or 8; pos: each sorted hit's row of grads (n, d);
// emb (rows, d) and acc (rows,) f32, updated in place; partials: scratch of
// 2 * ceil(n / kChunk) rows of d floats.  Rows take 16-byte units where d is
// a multiple of 4 and grads, emb and partials lie on 16 bytes, else single
// floats: d up to 512, or 128 in single floats.  Returns
// cudaErrorInvalidValue for what it does not take, before anything
// launches, else the launches' CUDA error.
int sparse_adagrad_rowwise(const void* ids, int id_bytes,
                           const long long* pos, const float* grads,
                           float* emb, float* acc, float* partials,
                           long long n, long long rows, int d, float lr,
                           void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(grads) |
                         reinterpret_cast<uintptr_t>(emb) |
                         reinterpret_cast<uintptr_t>(partials);
  const bool vec = d % 4 == 0 && (bits & 15) == 0;
  const int units = vec ? d / 4 : d;
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long blocks = (chunks + kWarps - 1) / kWarps;
  if (n < 1 || d < 1 || units > 4 * 32 || (bits & 3) != 0 ||
      (id_bytes != 4 && id_bytes != 8) || blocks > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const Args a = {ids, pos, grads, emb, acc, partials, n, rows, d, units,
                  1.0f / static_cast<float>(d), lr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  return id_bytes == 4 ? launch_vec<int32_t>(a, vec, grid, s)
                       : launch_vec<long long>(a, vec, grid, s);
}

}  // extern "C"
