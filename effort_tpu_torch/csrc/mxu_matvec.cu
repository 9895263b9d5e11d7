// Row-prefix effort matvec (bucket_size = 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:_kernel_mxu
// (entry mxu_matvec, fused_stream.py:616-684). What it computes, for one
// instance e of a packed [E*nc+1, G, OBv] value tensor:
//
//   scores  = |v[::stride][:P] * probes_e|
//   cutoff  = two-level 32-threshold search at kq = clip(rint(P*eff), 1, P),
//             eff the 16.16 fixed-point effort; geometric thresholds
//             m*exp((j+1) ln 0.62), then linear ones hi-(hi-lo)(j+1)/32
//             (fused_stream.py:98-142; the table comes from the wrapper)
//   sel_i   = stats_i * |v_i| > cutoff
//   u_i     = bf16(v_i * sel_i * scale_i)
//   C       = shortest prefix of the nc row chunks holding tau of the
//             selected mass, 1 <= C <= nc (fused_stream.py:61-96)
//   y[j]    = sum over rows r < C*G of u_r * W_e[r, j], accumulated in f32
//
// Three launches on the caller's stream, no host sync: a one-block
// selection kernel writes u, C and the cutoff to scratch; the streaming
// GEMV reads C from device memory, so moving the effort knob changes
// nothing on the host and a decode step stays capturable in a CUDA graph;
// a small pass sums the row splits in a fixed order, so the output is
// deterministic and greedy tokens repeat run to run.
//
// Bound: the streamed bytes C*G*OBv*itemsize over 3.35 TB/s. w13 of
// Mistral-7B (4096 x 28672) in int8 at full coverage streams 117 MB, about
// 35 us. The design here is the simple one: 16-byte loads with a 4-row
// unroll per warp, partial sums through device memory. Left for later:
// a cp.async/TMA ring, skipping all-zero u rows inside the prefix, and
// fusing the selection into the streaming launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNL = 32;              // thresholds per search level
constexpr int kSelThreads = 1024;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kMaxP = 4096;          // probes per instance
constexpr int kMaxChunks = 1024;
constexpr int kSegRows = 256;        // rows per selection segment (at most)
constexpr int kMaxSegs = 2048;
constexpr int kStreamThreads = 256;  // 8 warps; one warp row = 512 bytes
constexpr int kWarps = kStreamThreads / 32;
constexpr int kUnroll = 4;

enum Kind { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ float warp_sum(float x) {
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

__global__ void __launch_bounds__(kSelThreads) select_kernel(
    const float* __restrict__ v, int in_dim, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, const int32_t* __restrict__ eff_q,
    const float* __restrict__ tables, int G, int nc, float tau,
    __nv_bfloat16* __restrict__ u, int32_t* __restrict__ c_out,
    float* __restrict__ cutoff_out) {
  __shared__ float s_scores[kMaxP];
  __shared__ float s_seg[kMaxSegs];
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
  const float eff = __fmul_rn((float)eff_q[0], 1.0f / 65536.0f);
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

  // selection, u, and the selected mass of every segment: one warp per
  // segment, four rows a lane in flight, a fixed reduction order
  const int spc = segs_per_chunk(G, nc);
  for (int sg = warp; sg < nc * spc; sg += kSelWarps) {
    const int c = sg / spc, q = sg % spc;
    const int r1 = c * G + ((q + 1) * G) / spc;
    float part = 0.f;
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
        if (sel) part = __fadd_rn(part, x);
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
      float mass = 0.f;
      for (int q = 0; q < spc; ++q) mass = __fadd_rn(mass, s_seg[c * spc + q]);
      acc += (double)mass;
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

// Accumulators per thread: 16 bytes of one row decode to 8 (bf16),
// 16 (int8) or 32 (int4: 16 low nibbles, then 16 high nibbles) columns.
template <int KIND>
struct Acc {
  static constexpr int N = KIND == kBf16 ? 8 : (KIND == kInt8 ? 16 : 32);
};

template <int KIND>
__device__ __forceinline__ void fma_row(float* acc, uint4 w, float uu) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  if (KIND == kBf16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[2 * q] = fmaf(uu, bf16_lo(words[q]), acc[2 * q]);
      acc[2 * q + 1] = fmaf(uu, bf16_hi(words[q]), acc[2 * q + 1]);
    }
  } else if (KIND == kInt8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float x = (float)(int8_t)((words[q] >> (8 * b)) & 0xffu);
        acc[4 * q + b] = fmaf(uu, x, acc[4 * q + b]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (words[q] >> (8 * b)) & 0xffu;
        const float lo = (float)((int)(byte & 15u) - 8);
        const float hi = (float)((int)(byte >> 4) - 8);
        acc[4 * q + b] = fmaf(uu, lo, acc[4 * q + b]);
        acc[16 + 4 * q + b] = fmaf(uu, hi, acc[16 + 4 * q + b]);
      }
    }
  }
}

// Decoded column of accumulator k for the thread whose 16 bytes start at
// byte cb of a row of row_bytes bytes.
template <int KIND>
__device__ __forceinline__ int acc_col(int cb, int k, int row_bytes) {
  if (KIND == kBf16) return cb / 2 + k;
  if (KIND == kInt8) return cb + k;
  return k < 16 ? cb + k : row_bytes + cb + (k - 16);
}

// grid (ceil(row_bytes / 512), ceil(in_dim / rows_per_block)). Block y
// owns rows [y*RB, min((y+1)*RB, C*G)) and writes partial[y][:] for its
// column tile; blocks past the streamed prefix exit at once.
template <int KIND>
__global__ void __launch_bounds__(kStreamThreads) stream_kernel(
    const uint8_t* __restrict__ vals, int row_bytes, int G,
    const int32_t* __restrict__ c_in, const __nv_bfloat16* __restrict__ u,
    int rows_per_block, float* __restrict__ partial, int width) {
  constexpr int N = Acc<KIND>::N;
  __shared__ float s_acc[kWarps][N][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * rows_per_block;
  const int r_end = min(r0 + rows_per_block, c_in[0] * G);
  if (r0 >= r_end) return;
  const int cb = (blockIdx.x * 32 + lane) * 16;
  const bool active = cb < row_bytes;

  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
  const uint16_t* ub = reinterpret_cast<const uint16_t*>(u);
  if (active) {
    for (int r = r0 + warp; r < r_end; r += kWarps * kUnroll) {
      uint4 w[kUnroll];
      float uu[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int rr = r + q * kWarps;
        if (rr < r_end) {
          w[q] = __ldcs(reinterpret_cast<const uint4*>(
              vals + (size_t)rr * row_bytes + cb));
          uu[q] = __uint_as_float((uint32_t)ub[rr] << 16);
        } else {
          w[q] = make_uint4(0u, 0u, 0u, 0u);
          uu[q] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) fma_row<KIND>(acc, w[q], uu[q]);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) s_acc[warp][k][lane] = acc[k];
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * 32; idx += kStreamThreads) {
    const int k = idx / 32, l = idx % 32;
    const int cbl = (blockIdx.x * 32 + l) * 16;
    if (cbl >= row_bytes) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_acc[w][k][l];
    partial[(size_t)blockIdx.y * width + acc_col<KIND>(cbl, k, row_bytes)] =
        s;
  }
}

// y[j] = sum over the live splits s < ceil(C*G / RB) of partial[s][j], in
// split order.
__global__ void reduce_kernel(const float* __restrict__ partial, int width,
                              int out_dim, const int32_t* __restrict__ c_in,
                              int G, int rows_per_block,
                              float* __restrict__ y) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_dim) return;
  const int live = (c_in[0] * G + rows_per_block - 1) / rows_per_block;
  float s = 0.f;
  for (int sp = 0; sp < live; ++sp) s += partial[(size_t)sp * width + j];
  y[j] = s;
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t on that card. Returns the CUDA error of the
// launches (0 = none).
int effort_mxu_matvec(const float* v, const float* probes,
                      const float* stats, const float* scales,
                      const int32_t* eff_q, const float* tables,
                      const void* vals, int kind, int in_dim, int row_bytes,
                      int out_dim, int G, int nc, int P, int stride,
                      float tau, int rows_per_block, int width,
                      void* u, int32_t* c_out, float* cutoff_out,
                      float* partial, float* y, int device,
                      void* stream) {
  if (P < 1 || P > kMaxP || nc < 1 || nc > kMaxChunks || kind < 0 ||
      kind > 2 || row_bytes % 16 != 0 ||
      nc * segs_per_chunk(G, nc) > kMaxSegs)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* ub = static_cast<__nv_bfloat16*>(u);
  select_kernel<<<1, kSelThreads, 0, st>>>(v, in_dim, P, stride, probes,
                                           stats, scales, eff_q, tables, G,
                                           nc, tau, ub, c_out, cutoff_out);
  const dim3 grid((row_bytes + 511) / 512,
                  (in_dim + rows_per_block - 1) / rows_per_block);
  const uint8_t* vb = static_cast<const uint8_t*>(vals);
  if (kind == kBf16)
    stream_kernel<kBf16><<<grid, kStreamThreads, 0, st>>>(
        vb, row_bytes, G, c_out, ub, rows_per_block, partial, width);
  else if (kind == kInt8)
    stream_kernel<kInt8><<<grid, kStreamThreads, 0, st>>>(
        vb, row_bytes, G, c_out, ub, rows_per_block, partial, width);
  else
    stream_kernel<kInt4><<<grid, kStreamThreads, 0, st>>>(
        vb, row_bytes, G, c_out, ub, rows_per_block, partial, width);
  reduce_kernel<<<(out_dim + 255) / 256, 256, 0, st>>>(
      partial, width, out_dim, c_out, G, rows_per_block, y);
  return (int)cudaGetLastError();
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
