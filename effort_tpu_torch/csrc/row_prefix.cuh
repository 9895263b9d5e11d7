// Device code shared by the row-prefix effort kernels for Hopper, sm_90a:
// mxu_matvec.cu (one vector, K1) and mxu_matvec_batch.cu (T slots, K2).
// The rank-prefix selection (rank_prefix.cuh, K4) takes its cutoff search
// and its chunk-prefix scan from here too (find_cutoff, chunk_prefix_len).
//
// The selection of one vector (the TPU kernels' prologue,
// effort_tpu/kernels/fused_stream.py:_kernel_mxu and _kernel_mxu_batch):
//
//   scores  = |v[::stride][:P] * probes|
//   cutoff  = two-level 32-threshold search at kq = clip(rint(P*eff), 1, P);
//             geometric thresholds m*exp((j+1) ln 0.62), then linear ones
//             hi-(hi-lo)(j+1)/32 (fused_stream.py:98-142; the table comes
//             from the wrapper)                                (find_cutoff)
//   sel_i   = stats_i * |v_i| > cutoff
//   u_i     = bf16(v_i * sel_i * scale_i)                     (chunk_masses)
//   C       = shortest prefix of the nc row chunks holding tau of the
//             selected mass, 1 <= C <= nc (fused_stream.py:61-96); masses
//             add in f64 and each prefix is rounded to f32 once
//                                                         (chunk_prefix_len)
//
// K1 spreads it over a grid of blocks that own whole chunks
// (mxu_matvec.cu); K2 runs select_rows, one block a slot. The callers
// differ in how the effort arrives: K1 decodes a 16.16 fixed-point int32,
// K2 reads one f32 per slot (fused_stream.py:289-290 against :415-416), so
// kq can differ at its rounding boundaries.
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
constexpr int kScores = kMaxP / kSelThreads;  // scores a thread holds
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

// Whether a selection of nc chunks of G rows over P probes fits (also any
// run of fewer of those chunks).
__host__ __forceinline__ bool select_fits(int P, int G, int nc) {
  return P >= 1 && P <= kMaxP && nc >= 1 && nc <= kMaxChunks &&
         nc * segs_per_chunk(G, nc) <= kMaxSegs;
}

// Where score s falls among the kNL non-increasing thresholds t(0..kNL):
// the number of them it does not exceed (the first j with s > t(j)), so
// the count of scores above t(j) is the number whose bin is at most j.
// Walked from an estimate e, any value in 0..kNL: the thresholds are
// monotone, so the walk ends on the same bin whatever e is, and a close
// estimate takes two comparisons.
template <class Thr>
__device__ __forceinline__ int bin_from(float s, int e, Thr t) {
  while (e > 0 && s > t(e - 1)) --e;
  while (e < kNL && !(s > t(e))) ++e;
  return e;
}

// floor(x) clamped to 0..kNL (NaN to 0): a bin estimate
__device__ __forceinline__ int clamp_bin(float x) {
  return (int)fminf(fmaxf(floorf(x), 0.f), (float)kNL);
}

// One level of the threshold search (fused_stream.py:_vec_cutoff.level),
// over thresholds t with bin estimates est(s):
// the number of thresholds whose count of scores above them is below kq,
// which is the first index whose count reaches kq (counts grow along the
// level). Each warp bins its scores into its own histogram (hist, rows of
// kNL, zeroed by the caller; a score above no threshold, most of them at
// the second level, is in no count and adds nothing); after one barrier
// every warp adds the histograms itself (lane j bin j), and a scan over
// the lanes gives lane j the count above threshold j. Integer counts:
// exact, whatever the order, so the same answer as counting every score
// against every threshold.
template <class Thr, class Est>
__device__ __forceinline__ int level_misses(const float* sc, int* hist,
                                            int kq, Thr t, Est est) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kScores; ++k) {
    if (!(sc[k] >= 0.f)) continue;
    const int b = bin_from(sc[k], est(sc[k]), t);
    if (b < kNL) atomicAdd(&hist[warp * kNL + b], 1);
  }
  __syncthreads();
  int c = 0;
#pragma unroll 8
  for (int w = 0; w < kSelWarps; ++w) c += hist[w * kNL + lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += y;
  }
  return __popc(__ballot_sync(0xffffffffu, c < kq));
}

// The cutoff of one vector at effort eff, found by one block of
// kSelThreads threads (every thread returns it): the two-level search over
// scores = |v[::stride][:P] * probes|, with the thresholds of the table
// (geometric factors, then linear fractions). Each thread keeps its
// kScores scores in registers for both levels; three barriers in all.
// The estimates only set where a score's walk starts: every comparison
// that decides a bin is against a threshold as _vec_cutoff computes it.
// Shared by K1, K2 and K4, which call it once a block.
__device__ __forceinline__ float find_cutoff(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, float eff,
    const float* __restrict__ tables) {
  __shared__ float s_wmax[kSelWarps];
  __shared__ float s_tab[2 * kNL];
  __shared__ int s_hist[2][kSelWarps * kNL];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 2 * kNL) s_tab[tid] = tables[tid];
  s_hist[0][tid] = 0;
  s_hist[1][tid] = 0;
  float sc[kScores];
  float mx = 0.f;  // scores are >= 0; -1 marks past P
#pragma unroll
  for (int k = 0; k < kScores; ++k) {
    const int i = tid + k * kSelThreads;
    sc[k] = i < P ? fabsf(__fmul_rn(v[(size_t)i * stride], probes[i])) : -1.f;
    mx = fmaxf(mx, sc[k]);
  }
  mx = warp_max(mx);
  if (lane == 0) s_wmax[tid >> 5] = mx;
  __syncthreads();
  const float m = __fadd_rn(warp_max(s_wmax[lane]), 1e-30f);
  const int kq = (int)fminf(fmaxf(rintf(__fmul_rn((float)P, eff)), 1.f),
                            (float)P);
  // level 1: geometric thresholds below the max, m * 0.62^(j+1) (the
  // table's ratio, fused_stream._RATIO), so s's bin is about
  // log(s/m) / log(0.62)
  const float log2m = __log2f(m);
  const int nh = level_misses(
      sc, s_hist[0], kq, [&](int j) { return __fmul_rn(m, s_tab[j]); },
      [&](float x) {
        return clamp_bin((__log2f(x) - log2m) * -1.4499901f);  // 1/log2 .62
      });
  const float lo = nh < kNL ? __fmul_rn(m, s_tab[nh]) : 0.f;
  const float hi = (nh < kNL && nh >= 1) ? __fmul_rn(m, s_tab[nh - 1]) : m;
  // level 2: linear thresholds inside [lo, hi], hi - span * (j+1)/kNL, so
  // s's bin is about kNL (hi - s) / span
  const float span = __fsub_rn(hi, lo);
  const float per = (float)kNL / span;
  auto t2 = [&](int j) {
    return __fsub_rn(hi, __fmul_rn(span, s_tab[kNL + j]));
  };
  const int nh2 = level_misses(sc, s_hist[1], kq, t2, [&](float x) {
    return clamp_bin((hi - x) * per);
  });
  return nh2 < kNL ? t2(nh2) : lo;
}

// Selection, u and the selected mass of the nch chunks from chunk c0 (rows
// c0*G .. (c0+nch)*G of v [.., G], stats and scales), by one block of
// kSelThreads threads: writes u for those rows and, on return, s_seg[c]
// holds chunk c0 + c's mass (f64; s_seg holds nch * segs_per_chunk(G, nch)
// segments before). One warp a segment, four rows a lane in flight. Masses
// add in f64, where a sum of f32 terms is exact unless they span more than
// 2^29 in magnitude, so C does not depend on the order of the additions
// (nor do the plain version's and the kernels' disagree where a prefix
// meets tau*tot).
__device__ __forceinline__ void chunk_masses(
    const float* __restrict__ v, const float* __restrict__ stats,
    const float* __restrict__ scales, float cutoff, int G, int c0, int nch,
    __nv_bfloat16* __restrict__ u, double* s_seg) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int spc = segs_per_chunk(G, nch);
  for (int sg = warp; sg < nch * spc; sg += kSelWarps) {
    const int c = c0 + sg / spc, q = sg % spc;
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
  double mass = 0.0;
  if (tid < nch)
    for (int q = 0; q < spc; ++q) mass += s_seg[tid * spc + q];
  __syncthreads();
  if (tid < nch) s_seg[tid] = mass;
  __syncthreads();
}

// The stream length C of chunk masses ms[0..nc) (f64, in chunk order), by
// one warp (every lane returns it): the inclusive prefixes of the masses,
// each rounded to f32 once; C = #(prefix < tau * total) + 1, at most nc (an
// empty selection streams one chunk). Lane l takes the chunks [l*m, l*m +
// m): a serial sum, a warp scan of the lane sums, then the lane's
// prefixes. The f64 sums are exact, so the order changes no bit.
__device__ __forceinline__ int chunk_prefix_len(const double* ms, int nc,
                                                float tau) {
  const int lane = threadIdx.x & 31, m = (nc + 31) / 32;
  const int c0 = min(lane * m, nc), c1 = min(c0 + m, nc);
  double own = 0.0;
  for (int c = c0; c < c1; ++c) own += ms[c];
  double x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  const float thr =
      __fmul_rn(tau, __double2float_rn(__shfl_sync(0xffffffffu, x, 31)));
  double acc = __shfl_up_sync(0xffffffffu, x, 1);  // the chunks before c0
  if (lane == 0) acc = 0.0;
  int below = 0;
  for (int c = c0; c < c1; ++c) {
    acc += ms[c];
    below += __double2float_rn(acc) < thr ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    below += __shfl_xor_sync(0xffffffffu, below, o);
  return min(below + 1, nc);
}

// The selection of one vector v [nc*G] by one block of kSelThreads
// threads (K2, a block a slot): writes u [nc*G] bf16, *c_out (the streamed
// chunk count C) and *cutoff_out.
__device__ __forceinline__ void select_rows(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, float eff,
    const float* __restrict__ tables, int G, int nc, float tau,
    __nv_bfloat16* __restrict__ u, int32_t* __restrict__ c_out,
    float* __restrict__ cutoff_out) {
  __shared__ double s_seg[kMaxSegs];
  const float cutoff = find_cutoff(v, P, stride, probes, eff, tables);
  chunk_masses(v, stats, scales, cutoff, G, 0, nc, u, s_seg);
  if (threadIdx.x < 32) {
    const int C = chunk_prefix_len(s_seg, nc, tau);
    if (threadIdx.x == 0) {
      c_out[0] = C;
      cutoff_out[0] = cutoff;
    }
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

// byte b of w as a float: 2^23 + b read as a float, less `bias` (exact)
__device__ __forceinline__ float byte_float(uint32_t w, int b, float bias) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + b)) - bias;
}

// int8 as its byte flipped to unsigned (b ^ 0x80 = b + 128), less 2^23 +
// 128; int4 nibble n as n less 2^23 + 8: one permute and one add a value,
// at the full rate, where a conversion instruction runs at a quarter of it
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
      const uint32_t f = words[q] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) x[4 * q + b] = byte_float(f, b, 8388736.f);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = words[q] & 0x0f0f0f0fu;
      const uint32_t hi = (words[q] >> 4) & 0x0f0f0f0fu;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        x[4 * q + b] = byte_float(lo, b, 8388616.f);
        x[16 + 4 * q + b] = byte_float(hi, b, 8388616.f);
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
