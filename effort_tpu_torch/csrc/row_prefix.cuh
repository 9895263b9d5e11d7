// Device code shared by the row-prefix effort kernels for Hopper, sm_90a:
// mxu_matvec.cu (one vector, K1) and mxu_matvec_batch.cu (T slots, K2).
// The rank-prefix selection (rank_prefix.cuh, K4) takes its cutoff search
// from here too (find_cutoff).
//
// select_rows() is one block's whole selection for one vector (the TPU
// kernels' prologue, effort_tpu/kernels/fused_stream.py:_kernel_mxu and
// _kernel_mxu_batch):
//
//   scores  = |v[::stride][:P] * probes|
//   cutoff  = two-level 32-threshold search at kq = clip(rint(P*eff), 1, P);
//             geometric thresholds m*exp((j+1) ln 0.62), then linear ones
//             hi-(hi-lo)(j+1)/32 (fused_stream.py:98-142; the table comes
//             from the wrapper)
//   sel_i   = stats_i * |v_i| > cutoff
//   u_i     = bf16(v_i * sel_i * scale_i)
//   C       = shortest prefix of the nc row chunks holding tau of the
//             selected mass, 1 <= C <= nc (fused_stream.py:61-96); masses
//             add in f64 and each prefix is rounded to f32 once
//
// The callers differ only in how the effort arrives: K1 decodes a 16.16
// fixed-point int32, K2 reads one f32 per slot (fused_stream.py:289-290
// against :415-416), so kq can differ at its rounding boundaries.
//
// decode16() turns 16 bytes of a weight row into 8 (bf16), 16 (int8) or
// 32 (int4: 16 low nibbles, then 16 high nibbles) f32 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace row_prefix {

constexpr int kNL = 32;              // thresholds per search level
constexpr int kSelThreads = 1024;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kMaxP = 4096;          // probes per instance
constexpr int kMaxChunks = 1024;
constexpr int kSegRows = 256;        // rows per selection segment (at most)
constexpr int kMaxSegs = 2048;

enum Kind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Selection segments: each of the nc chunks is cut into spc row segments
// of at most kSegRows rows, and at least one segment per warp overall, so
// every warp has rows to load.
__host__ __device__ __forceinline__ int segs_per_chunk(int G, int nc) {
  const int by_rows = (G + kSegRows - 1) / kSegRows;
  const int by_warps = (kSelWarps + nc - 1) / nc;
  return by_rows > by_warps ? by_rows : by_warps;
}

// Whether select_rows takes these sizes.
__host__ __forceinline__ bool select_fits(int P, int G, int nc) {
  return P >= 1 && P <= kMaxP && nc >= 1 && nc <= kMaxChunks &&
         nc * segs_per_chunk(G, nc) <= kMaxSegs;
}

// One level of the threshold search (fused_stream.py:_vec_cutoff.level)
// over the descending thresholds s_t[0..kNL). Each warp counts 32 scores
// at a time against every threshold with one ballot each; lane j keeps the
// count for threshold j, and the warps' counts meet in s_cnt (integer
// sums: exact, whatever the order). The first index whose count reaches
// kq equals the number of misses, since counts grow along the level.
__device__ __forceinline__ void search_level(const float* s_scores, int P,
                                             const float* s_t, int* s_cnt,
                                             float kq, float lo0, float hi0,
                                             float* lo, float* hi) {
  const int lane = threadIdx.x & 31;
  int mine = 0;
  for (int base = threadIdx.x - lane; base < P; base += kSelThreads) {
    const int i = base + lane;
    const float s = i < P ? s_scores[i] : -1.f;  // thresholds are >= 0
#pragma unroll
    for (int j = 0; j < kNL; ++j) {
      const int n = __popc(__ballot_sync(0xffffffffu, s > s_t[j]));
      if (j == lane) mine += n;
    }
  }
  atomicAdd(&s_cnt[lane], mine);
  __syncthreads();
  int nh = 0;
#pragma unroll
  for (int j = 0; j < kNL; ++j) nh += (float)s_cnt[j] < kq ? 1 : 0;
  *lo = nh < kNL ? s_t[nh] : lo0;
  *hi = (nh < kNL && nh >= 1) ? s_t[nh - 1] : hi0;
  __syncthreads();  // s_t and s_cnt are rewritten next
}

// The cutoff of one vector at effort eff, found by one block of
// kSelThreads threads (every thread returns it): the two-level search over
// scores = |v[::stride][:P] * probes|. Shared by the row-prefix selection
// below and the rank-prefix one (rank_prefix.cuh).
__device__ __forceinline__ float find_cutoff(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, float eff,
    const float* __restrict__ tables) {
  __shared__ float s_scores[kMaxP];
  __shared__ float s_wmax[kSelWarps];
  __shared__ float s_t[kNL];
  __shared__ int s_cnt[kNL];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float mx = 0.f;  // scores are >= 0
#pragma unroll 4
  for (int i = tid; i < P; i += kSelThreads) {
    const float s = fabsf(__fmul_rn(v[(size_t)i * stride], probes[i]));
    s_scores[i] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  if (lane == 0) s_wmax[warp] = mx;
  __syncthreads();
  mx = s_wmax[0];
  for (int w = 1; w < kSelWarps; ++w) mx = fmaxf(mx, s_wmax[w]);
  const float m = __fadd_rn(mx, 1e-30f);
  const float kq = fminf(fmaxf(rintf(__fmul_rn((float)P, eff)), 1.f),
                         (float)P);

  // level 1: geometric thresholds below the max
  if (tid < kNL) s_t[tid] = __fmul_rn(m, tables[tid]);
  if (tid < kNL) s_cnt[tid] = 0;
  __syncthreads();
  float lo, hi;
  search_level(s_scores, P, s_t, s_cnt, kq, 0.f, m, &lo, &hi);
  // level 2: linear thresholds inside [lo, hi]
  if (tid < kNL)
    s_t[tid] = __fsub_rn(hi, __fmul_rn(__fsub_rn(hi, lo), tables[kNL + tid]));
  if (tid < kNL) s_cnt[tid] = 0;
  __syncthreads();
  float cutoff, unused;
  search_level(s_scores, P, s_t, s_cnt, kq, lo, hi, &cutoff, &unused);
  return cutoff;
}

// The selection of one vector v [nc*G] by one block of kSelThreads
// threads: writes u [nc*G] bf16, *c_out (the streamed chunk count C) and
// *cutoff_out.
__device__ __forceinline__ void select_rows(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, float eff,
    const float* __restrict__ tables, int G, int nc, float tau,
    __nv_bfloat16* __restrict__ u, int32_t* __restrict__ c_out,
    float* __restrict__ cutoff_out) {
  __shared__ double s_seg[kMaxSegs];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float cutoff = find_cutoff(v, P, stride, probes, eff, tables);

  // selection, u, and the selected mass of every segment: one warp per
  // segment, four rows a lane in flight. Masses add in f64, where a sum of
  // f32 terms is exact unless they span more than 2^29 in magnitude, so C
  // does not depend on the order of the additions (nor do the plain
  // version's and this kernel's disagree where a prefix meets tau*tot)
  const int spc = segs_per_chunk(G, nc);
  for (int sg = warp; sg < nc * spc; sg += kSelWarps) {
    const int c = sg / spc, q = sg % spc;
    const int r1 = c * G + ((q + 1) * G) / spc;
    double part = 0.0;
    for (int i = c * G + (q * G) / spc + lane; i < r1; i += 32 * 4) {
      float vi[4], st[4], sc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ii = i + 32 * k;
        vi[k] = ii < r1 ? v[ii] : 0.f;
        st[k] = ii < r1 ? stats[ii] : 0.f;
        sc[k] = (ii < r1 && scales != nullptr) ? scales[ii] : 1.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ii = i + 32 * k;
        if (ii >= r1) break;
        const float x = __fmul_rn(st[k], fabsf(vi[k]));
        const bool sel = x > cutoff;
        if (sel) part += (double)x;
        const float ui = scales != nullptr ? __fmul_rn(vi[k], sc[k]) : vi[k];
        u[ii] = __float2bfloat16_rn(sel ? ui : 0.f);
      }
    }
    part = warp_sum(part);
    if (lane == 0) s_seg[sg] = part;
  }
  __syncthreads();

  if (tid == 0) {
    // chunk masses, then a serial prefix in chunk order, each prefix
    // rounded to f32 once
    double acc = 0.0;
    float tot = 0.f;
    for (int c = 0; c < nc; ++c) {
      for (int q = 0; q < spc; ++q) acc += s_seg[c * spc + q];
      const float cum = __double2float_rn(acc);
      s_seg[c] = cum;  // chunk c's segments are all read by now
      tot = fmaxf(tot, cum);
    }
    const float thr = __fmul_rn(tau, tot);
    int below = 0;
    for (int c = 0; c < nc; ++c) below += s_seg[c] < thr ? 1 : 0;
    c_out[0] = min(below + 1, nc);  // an empty selection streams 1 chunk
    cutoff_out[0] = cutoff;
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Columns per 16 bytes of a row.
template <int KIND>
struct Acc {
  static constexpr int N = KIND == kBf16 ? 8 : (KIND == kInt8 ? 16 : 32);
};

template <int KIND>
__device__ __forceinline__ void decode16(uint4 w, float* x) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  if (KIND == kBf16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[2 * q] = bf16_lo(words[q]);
      x[2 * q + 1] = bf16_hi(words[q]);
    }
  } else if (KIND == kInt8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        x[4 * q + b] = (float)(int8_t)((words[q] >> (8 * b)) & 0xffu);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (words[q] >> (8 * b)) & 0xffu;
        x[4 * q + b] = (float)((int)(byte & 15u) - 8);
        x[16 + 4 * q + b] = (float)((int)(byte >> 4) - 8);
      }
    }
  }
}

// acc[k] += uu * column k of the 16 bytes w
template <int KIND>
__device__ __forceinline__ void fma_row(float* acc, uint4 w, float uu) {
  float x[Acc<KIND>::N];
  decode16<KIND>(w, x);
#pragma unroll
  for (int k = 0; k < Acc<KIND>::N; ++k) acc[k] = fmaf(uu, x[k], acc[k]);
}

// Decoded column of accumulator k for the thread whose 16 bytes start at
// byte cb of a row of row_bytes bytes (int4: byte j holds columns j and
// j + row_bytes).
template <int KIND>
__device__ __forceinline__ int acc_col(int cb, int k, int row_bytes) {
  if (KIND == kBf16) return cb / 2 + k;
  if (KIND == kInt8) return cb + k;
  return k < 16 ? cb + k : row_bytes + cb + (k - 16);
}

}  // namespace row_prefix
