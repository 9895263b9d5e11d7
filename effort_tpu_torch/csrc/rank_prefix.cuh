// Device code shared by the rank-prefix effort kernels for Hopper, sm_90a
// (bucket_size B >= 2): fused_matvec.cu (K4), stream_matvec.cu (K5), and,
// through block_gather.cuh, gather_dma.cu (K6) and gather_mul.cu (K7).
//
// Layout (ops/layouts.py). Block (e*K + k)*nc + g holds the rank-k bucket
// values of input rows g*G .. g*G+G-1 of instance e, [G, OBv] bf16, int8
// or int4 (uint8 bytes, low nibble = columns < OBv/2, high nibble the
// rest); the positions of the same elements within their buckets, [G, OBp]
// uint8, pack 8/bits of them a byte: byte jb holds column t*OBp + jb at
// shift t*bits. The last block is all zeros. Output y[j*B + p] is the sum
// of u[k, r] * W_k[r, j] over the rows r and ranks k whose position at
// (r, j) is p (effort_tpu/kernels/prefix_stream.py:210).
//
// select_ranks() is K4's selection by one block, on the 16.16 effort
// (effort_tpu/kernels/fused_stream.py:_kernel, :157-186):
//   cutoff  = row_prefix::find_cutoff (the same search and table as K1)
//   n_i     = #{k < K : stats[i, k] * |v_i| > cutoff}
//   u[k, i] = v_i * [k < n_i] * scale[i, k]                 (f32, not bf16)
//   C_k     = shortest chunk prefix holding tau of rank k's selected mass
//             (masses add in f64, each prefix rounded to f32 once)
//   tiles   = ceil(C_k / TGB) per rank; cum_tiles [K+1], base_blocks [K]
//
// stream_kernel() is the stream K4 and K5 share: tile t of the flattened
// per-rank prefixes (TGB chunks of one rank) is streamed whole, rounded-up
// tail included. accum_rows() is the body K6 and K7 share with it.
//
// Work is split over (column block, split). A lane owns NBT consecutive
// position bytes and so NBT * (8/bits) columns, B accumulators each, 64 in
// all; the block's four warps take every fourth row of a tile for the same
// 32 lanes' columns, and add their sums in warp order at the end; a split
// walks tiles split, split + S, ... and writes its partial sums;
// reduce_splits adds the live splits in split order. No atomics: a
// rerun gives the same bits. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: no fused multiply-add) and the order is fixed, so
// the plain versions (kernels/prefix_stream.split_sum) repeat it bit for
// bit.

#pragma once

#include "row_prefix.cuh"

namespace rank_prefix {

using row_prefix::kBf16;
using row_prefix::kInt4;
using row_prefix::kInt8;
using row_prefix::kSelThreads;
using row_prefix::kSelWarps;

constexpr int kMaxRanks = 32;
constexpr int kMaxTileRows = 2048;   // u rows staged in shared memory
constexpr int kRowWarps = 4;         // warps of a block, one row in 4 each
constexpr int kThreads = 32 * kRowWarps;
constexpr int kMaxMasses = 24576;    // K * nc f64 masses (dynamic shared)
constexpr int kAccs = 64;            // accumulators a thread

// Positions packed bits to a field (layouts.pack_positions).
template <int B>
struct PackedPos {
  static constexpr int kBits =
      B == 2 ? 1 : (B == 4 ? 2 : (B == 8 ? 3 : (B == 16 ? 4 : 5)));
  static constexpr int kPerByte = 8 / kBits;
  __device__ static __forceinline__ int at(uint32_t byte, int t) {
    return (int)((byte >> (t * kBits)) & ((1u << kBits) - 1u));
  }
};

// Positions one byte a column (BucketedMatrix.pos_unpacked()).
template <int B>
struct BytePos {
  static constexpr int kPerByte = 1;
  __device__ static __forceinline__ int at(uint32_t byte, int) {
    return (int)byte;
  }
};

// Position bytes a thread owns.
template <int B, class Pos>
struct Owned {
  static constexpr int kNBT = kAccs / (Pos::kPerByte * B);
};

// NB bytes at p (aligned to min(NB, 16)) as 32-bit words, streamed past L1.
template <int NB>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint32_t* w) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 x = __ldcs(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else if constexpr (NB == 4) {
    w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
  } else {
    static_assert(NB == 2, "2, 4, 8 or a multiple of 16 bytes");
    w[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t* w, int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
}

// Value i of a group of columns loaded as words (int4: hi = the high
// nibbles, the columns at or past OBv/2).
template <int KIND>
__device__ __forceinline__ float value_at(const uint32_t* w, int i, bool hi) {
  if constexpr (KIND == kBf16) {
    const uint32_t x = w[i >> 1];
    return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
  } else if constexpr (KIND == kInt8) {
    return (float)(int8_t)byte_at(w, i);
  } else {
    return (float)((int)((byte_at(w, i) >> (hi ? 4 : 0)) & 15u) - 8);
  }
}

// acc[(t*NBT + i)*B + p] += u_r * W[r, c] (each rounded, in row order; the
// other B-1 accumulators add 0) for the rows r = r0, r0 + kRowWarps, ...
// < nrows from global row row0 on, where c = t*prow + jb0 + i (t < 8/bits,
// i < NBT) is one of the thread's columns and p its position. s_u holds u
// of the rows. half: int4 value row bytes (columns >= half are the high
// nibbles).
template <int KIND, int B, class Pos>
__device__ __forceinline__ void accum_rows(
    const uint8_t* __restrict__ vals, int vrow,
    const uint8_t* __restrict__ pos, int prow, int half, size_t row0,
    int r0, int nrows, const float* s_u, int jb0, int OB, float* acc) {
  constexpr int PB = Pos::kPerByte;
  constexpr int NBT = Owned<B, Pos>::kNBT;
  constexpr int VB = KIND == kBf16 ? 2 * NBT : NBT;   // value bytes a group
  constexpr int PW = (NBT + 3) / 4, VW = (VB + 3) / 4;
  // rows in flight: up to 8, while their loads take at most 32 registers
  constexpr int U = PB * VW >= 16 ? 2 : (PB * VW >= 8 ? 4 : 8);
  int voff[PB];
  bool live[PB], hi[PB];
#pragma unroll
  for (int t = 0; t < PB; ++t) {
    const int c0 = t * prow + jb0;
    live[t] = c0 < OB;
    hi[t] = KIND == kInt4 && c0 >= half;
    voff[t] = KIND == kBf16 ? 2 * c0 : (hi[t] ? c0 - half : c0);
  }
  constexpr int S = kRowWarps;
  for (int r = r0; r < nrows; r += U * S) {
    uint32_t pw[U][PW], vw[U][PB][VW];
    float uu[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const bool in = r + q * S < nrows;
      const size_t row = row0 + r + q * S;
      uu[q] = in ? s_u[r + q * S] : 0.f;
      if (in) load_bytes<NBT>(pos + row * prow + jb0, pw[q]);
#pragma unroll
      for (int t = 0; t < PB; ++t)
        if (in && live[t]) load_bytes<VB>(vals + row * vrow + voff[t],
                                          vw[q][t]);
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (r + q * S >= nrows) break;
#pragma unroll
      for (int t = 0; t < PB; ++t) {
        if (!live[t]) continue;
#pragma unroll
        for (int i = 0; i < NBT; ++i) {
          const int p = Pos::at(byte_at(pw[q], i), t);
          const float x = __fmul_rn(uu[q], value_at<KIND>(vw[q][t], i,
                                                           hi[t]));
          float* a = acc + (t * NBT + i) * B;
#pragma unroll
          for (int pp = 0; pp < B; ++pp)
            a[pp] = __fadd_rn(a[pp], p == pp ? x : 0.f);
        }
      }
    }
  }
}

// partial[j*B + p] of the block's columns: each column's kRowWarps warp
// sums added in warp order (the warps took rows r = w mod kRowWarps).
// Every thread of the block calls it.
template <int B, class Pos>
__device__ __forceinline__ void write_partial(const float* acc, int prow,
                                              int OB,
                                              float* __restrict__ partial) {
  constexpr int NBT = Owned<B, Pos>::kNBT;
  __shared__ float s_acc[kRowWarps][kAccs][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kAccs; ++i) s_acc[warp][i][lane] = acc[i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kAccs * 32; idx += kThreads) {
    const int i = idx >> 5, l = idx & 31;
    const int jb0 = (blockIdx.x * 32 + l) * NBT;
    const int t = i / (NBT * B), c = t * prow + jb0 + (i / B) % NBT;
    if (jb0 >= prow || c >= OB) continue;
    float s = s_acc[0][i][l];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) s = __fadd_rn(s, s_acc[w][i][l]);
    partial[(size_t)c * B + i % B] = s;
  }
}

// grid (column blocks, S): split y streams tiles y, y + S, ... < cum[K]
// and writes partial[y][:]; splits past the last tile exit at once.
template <int KIND, int B>
__global__ void __launch_bounds__(kThreads) stream_kernel(
    const uint8_t* __restrict__ vals, int vrow,
    const uint8_t* __restrict__ pos, int prow, int half,
    const int32_t* __restrict__ cum_tiles,
    const int32_t* __restrict__ base_blocks, const float* __restrict__ u,
    int K, int G, int tgb, int in_dim, int OB,
    float* __restrict__ partial) {
  using Pos = PackedPos<B>;
  __shared__ float s_u[kMaxTileRows];
  __shared__ int s_cum[kMaxRanks + 1], s_base[kMaxRanks];
  if (threadIdx.x <= K) s_cum[threadIdx.x] = cum_tiles[threadIdx.x];
  if (threadIdx.x < K) s_base[threadIdx.x] = base_blocks[threadIdx.x];
  __syncthreads();
  const int total = s_cum[K];
  if ((int)blockIdx.y >= total) return;
  const int jb0 = (blockIdx.x * 32 + (threadIdx.x & 31)) *
                  Owned<B, Pos>::kNBT;
  const bool active = jb0 < prow;
  const int rows = tgb * G;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  for (int t = blockIdx.y; t < total; t += gridDim.y) {
    int k = 0;
    for (int j = 1; j < K; ++j) k += t >= s_cum[j] ? 1 : 0;
    const int chunk0 = (t - s_cum[k]) * tgb;
    const float* ut = u + (size_t)k * in_dim + (size_t)chunk0 * G;
    __syncthreads();  // the previous tile's u is read
    for (int i = threadIdx.x; i < rows; i += kThreads) s_u[i] = ut[i];
    __syncthreads();
    if (active)
      accum_rows<KIND, B, Pos>(vals, vrow, pos, prow, half,
                               (size_t)(s_base[k] + chunk0) * G,
                               threadIdx.x >> 5, rows, s_u, jb0, OB, acc);
  }
  write_partial<B, Pos>(acc, prow, OB, partial + (size_t)blockIdx.y * OB * B);
}

// y[j] = sum over the live splits s < min(S, live[0]) (all S when live is
// null) of partial[s][j], in split order.
__global__ void reduce_splits(const float* __restrict__ partial,
                              int out_dim, int S,
                              const int32_t* __restrict__ live,
                              float* __restrict__ y) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_dim) return;
  const int n = live != nullptr ? min(S, live[0]) : S;
  float s = 0.f;
  for (int sp = 0; sp < n; ++sp)
    s = __fadd_rn(s, partial[(size_t)sp * out_dim + j]);
  y[j] = s;
}

// K4's per-row selection work, R consecutive rows a thread (G % R == 0):
// n_i, u[k, i], and each row's selected mass x = stats[i, k] * |v_i|
// added into s_mass[k * nc + chunk] (zeroed by the caller). A thread sums
// its R rows, a segment of gcd(G / R, 32) lanes (inside one chunk) sums by
// shuffles, and the segment's sum goes in by an atomic. The f64 sums are
// exact, so their order does not change a bit.
template <int R>
__device__ __forceinline__ void rank_rows(
    const float* __restrict__ v, const float* __restrict__ stats,
    const float* __restrict__ scales, float cutoff, int G, int in_dim, int K,
    float* __restrict__ u, double* s_mass) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = in_dim / G;
  int seg = 32;
  while ((G / R) % seg) seg >>= 1;
  for (int j0 = warp * 32; j0 * R < in_dim; j0 += kSelThreads) {
    const int i0 = (j0 + lane) * R;  // the thread's first row
    const bool has = i0 < in_dim;
    float vi[R], av[R];
    int n[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vi[r] = has ? v[i0 + r] : 0.f;
      av[r] = fabsf(vi[r]);
      n[r] = 0;
    }
    const float* st = stats + (size_t)(has ? i0 : 0) * K;
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r)
        n[r] += (has && __fmul_rn(st[r * K + k], av[r]) > cutoff) ? 1 : 0;
    for (int k = 0; k < K; ++k) {
      double m = 0.0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool sel = k < n[r];
        if (has) {
          const float ui =
              scales != nullptr
                  ? __fmul_rn(vi[r], scales[(size_t)(i0 + r) * K + k])
                  : vi[r];
          u[(size_t)k * in_dim + i0 + r] = sel ? ui : 0.f;
        }
        if (sel) m += (double)__fmul_rn(st[r * K + k], av[r]);
      }
      for (int o = seg >> 1; o > 0; o >>= 1)
        m += __shfl_xor_sync(0xffffffffu, m, o);
      if (has && (lane & (seg - 1)) == 0)
        atomicAdd(&s_mass[k * nc + i0 / G], m);
    }
  }
}

// K4's selection for one vector by one block of kSelThreads threads (see
// the top of this file). Dynamic shared memory: K * nc doubles.
__device__ __forceinline__ void select_ranks(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, float eff,
    const float* __restrict__ tables, int G, int nc, int K, int tgb,
    float tau, int expert, float* __restrict__ u,
    int32_t* __restrict__ c_out, int32_t* __restrict__ cum_tiles,
    int32_t* __restrict__ base_blocks, float* __restrict__ cutoff_out) {
  extern __shared__ double s_mass[];  // [K][nc]
  __shared__ int s_len[kMaxRanks];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int in_dim = nc * G;
  const float cutoff = row_prefix::find_cutoff(v, P, stride, probes, eff,
                                               tables);

  // rank counts, u, and each (rank, chunk) selected mass
  for (int i = tid; i < K * nc; i += kSelThreads) s_mass[i] = 0.0;
  __syncthreads();
  if (G % 4 == 0)
    rank_rows<4>(v, stats, scales, cutoff, G, in_dim, K, u, s_mass);
  else
    rank_rows<1>(v, stats, scales, cutoff, G, in_dim, K, u, s_mass);
  __syncthreads();

  // per rank (one warp each): inclusive prefix of the chunk masses in f64
  // (exact, so the same in any order), each rounded to f32 once; C_k =
  // #(prefix < tau * total) + 1, at most nc. Lane l takes the m chunks
  // [l*m, l*m + m): a serial sum, one warp scan of the lane sums, then the
  // lane's prefixes and its count below tau * total.
  if (warp < K) {
    const int k = warp, m = (nc + 31) / 32;
    double* ms = s_mass + k * nc;
    const int c0 = min(lane * m, nc), c1 = min(c0 + m, nc);
    double own = 0.0;
    for (int c = c0; c < c1; ++c) own += ms[c];
    double x = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const double total = __shfl_sync(0xffffffffu, x, 31);
    double acc = __shfl_up_sync(0xffffffffu, x, 1);  // chunks before c0
    if (lane == 0) acc = 0.0;
    for (int c = c0; c < c1; ++c) {
      acc += ms[c];
      ms[c] = (double)__double2float_rn(acc);
    }
    const float thr = __fmul_rn(tau, __double2float_rn(total));
    int below = 0;
    for (int c = c0; c < c1; ++c) below += (float)ms[c] < thr ? 1 : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      below += __shfl_xor_sync(0xffffffffu, below, o);
    if (lane == 0) {
      const int C = min(below + 1, nc);  // an empty selection streams 1
      c_out[k] = C;
      s_len[k] = (C + tgb - 1) / tgb;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int cum = 0;
    cum_tiles[0] = 0;
    for (int k = 0; k < K; ++k) {
      cum += s_len[k];
      cum_tiles[k + 1] = cum;
      base_blocks[k] = (expert * K + k) * nc;
    }
    cutoff_out[0] = cutoff;
  }
}

// Calls f.template run<KIND, B>() for the run-time value kind and bucket
// size B; false when there is no such instance. With kInt4s false, int4
// values are refused.
template <bool kInt4s, class F>
bool dispatch(int kind, int B, F& f) {
#define EFFORT_RANK_CASE(KD)                  \
  if (kind == KD) {                           \
    switch (B) {                              \
      case 2: f.template run<KD, 2>(); return true;   \
      case 4: f.template run<KD, 4>(); return true;   \
      case 8: f.template run<KD, 8>(); return true;   \
      case 16: f.template run<KD, 16>(); return true; \
      case 32: f.template run<KD, 32>(); return true; \
      default: return false;                  \
    }                                         \
  }
  EFFORT_RANK_CASE(kBf16)
  EFFORT_RANK_CASE(kInt8)
  if constexpr (kInt4s) {
    EFFORT_RANK_CASE(kInt4)
  }
#undef EFFORT_RANK_CASE
  return false;
}

// The stream's launches on `stream` (K4 after its selection, K5 alone):
// stream_kernel over grid (column blocks, splits), then the split sum of
// the splits that held a tile. Returns the CUDA error (0 = none).
struct StreamLaunch {
  const uint8_t* vals;
  int vrow;
  const uint8_t* pos;
  int prow, half;
  const int32_t* cum_tiles;
  const int32_t* base_blocks;
  const float* u;
  int K, G, tgb, in_dim, OB;
  float* partial;
  dim3 grid;
  int threads;
  cudaStream_t stream;

  template <int KIND, int B>
  void run() {
    stream_kernel<KIND, B><<<grid, threads, 0, stream>>>(
        vals, vrow, pos, prow, half, cum_tiles, base_blocks, u, K, G, tgb,
        in_dim, OB, partial);
  }
};

inline int stream_matvec(int kind, int B, StreamLaunch& launch, float* y) {
  if (launch.K < 1 || launch.K > kMaxRanks || launch.threads != kThreads ||
      launch.tgb * launch.G > kMaxTileRows)
    return (int)cudaErrorInvalidValue;
  if (!dispatch<true>(kind, B, launch)) return (int)cudaErrorInvalidValue;
  const int out_dim = launch.OB * B;
  reduce_splits<<<(out_dim + 255) / 256, 256, 0, launch.stream>>>(
      launch.partial, out_dim, launch.grid.y, launch.cum_tiles + launch.K,
      y);
  return (int)cudaGetLastError();
}

}  // namespace rank_prefix
