// Causal blockwise (flash) attention for prefill, for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/flash_attention.py:_kernel
// (entry flash_attention, flash_attention.py:116-163; the forward_seq
// adapter flash_attention_seq, :166-187). What it computes, per KV head
// and for each of its rep query heads (GQA folded: query head h uses KV
// head h // rep):
//
//   s[t, k]  = bf16(q[t]) . k[k] * D^-0.5, f32 accumulate
//   live     = k <= slot(t) and k >= mask_from
//              and (window == 0 or k > slot(t) - window),
//              slot(t) = start_slot + t
//   out[t]   = sum_k softmax_live(s[t])[k] v[k], P@V in f32 (pv_f32) or
//              with the probabilities rounded to bf16
//   a query with no live key gets 0
//
// with the TPU kernel's online softmax (running max from -1e30, masked
// probabilities 0), so a fully masked row keeps l = 0 and writes 0.
//
// Grid (query blocks, KV heads). A block holds the rep*BQ <= 64 score rows
// of its KV head's rep query heads over BQ queries, as the TPU kernel folds
// GQA, so each K/V tile it loads serves all of them. It walks the KV tiles
// of 64 keys that any of its rows can see (tiles wholly in the future,
// behind the window or before mask_from are skipped: all their
// probabilities are 0, so skipping changes nothing) with K transposed and
// V in shared memory as f32. Thread (ty, tx) owns rows 4ty..4ty+3: score
// columns 4tx..4tx+3 of each tile and output columns 8tx..8tx+7; a row's
// max and sum meet over the 16 lanes of a half warp.
//
// Layouts come as element strides (the last axis contiguous), so the
// kernel reads the adapter's Q [T, H*D] f32 and the cache [S, KV, D] bf16
// in place and writes [T, H*D] f32, with no transposes.
//
// Bound: K/V bytes (read once per KV head) and the causal flops
// 4*T*S_live*H*D over the card's rates; here the flops run on CUDA cores
// in f32. Tensor-core (mma.sync/wgmma) tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // score rows (query head, query) a block
constexpr int kBK = 64;              // keys per tile
constexpr int kMaxD = 128;
constexpr int kQStride = kMaxD + 4;  // padded rows: no bank conflicts
constexpr int kKStride = kBK + 4;
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes =
    sizeof(float) * (kRows * kQStride + kMaxD * kKStride + kBK * kMaxD +
                     kRows * kPStride);

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// reduce over the 16 lanes of a half warp (one row's threads)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const float* q;
  long long q_skv, q_srep, q_st;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long k_skv, k_ss, v_skv, v_ss;
  float* out;
  long long o_skv, o_srep, o_st;
  int rep, T, S, D, BQ;
  int start_slot, mask_from, window, pv_f32;
  float scale;
};

__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kRows][kQStride]
  float* KsT = Qs + kRows * kQStride;     // [kMaxD][kKStride]
  float* Vs = KsT + kMaxD * kKStride;     // [kBK][kMaxD]
  float* Ps = Vs + kBK * kMaxD;           // [kRows][kPStride]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kv = blockIdx.y, qb = blockIdx.x, D = a.D, BQ = a.BQ;
  const int n_rows = a.rep * BQ;

  // row r = (query head r / BQ, query qb*BQ + r % BQ), as the TPU kernel
  // orders its score rows
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = qb * BQ + r % BQ;
    float x = 0.f;
    if (r < n_rows && t < a.T)
      x = round_bf16(a.q[kv * a.q_skv + (r / BQ) * a.q_srep + t * a.q_st + d]);
    Qs[r * kQStride + d] = x;
  }

  int slot[4];
  bool valid[4];
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, t = qb * BQ + r % BQ;
    valid[i] = r < n_rows && t < a.T;
    slot[i] = a.start_slot + t;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // the keys any row of this block can see
  const int q_min = a.start_slot + qb * BQ;
  const int q_max = a.start_slot + min(qb * BQ + BQ, a.T) - 1;
  int k_lo = a.mask_from;
  if (a.window > 0) k_lo = max(k_lo, q_min - a.window + 1);
  k_lo = max(k_lo, 0);
  const int k_hi = min(q_max, a.S - 1);
  const int d8s = D / 8;

  for (int kb = k_lo / kBK; kb * kBK <= k_hi; ++kb) {
    __syncthreads();  // Qs written / the previous tile's Ps and Vs read
    for (int idx = tid; idx < kBK * d8s; idx += kThreads) {
      const int c = idx / d8s, d = (idx % d8s) * 8, s = kb * kBK + c;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (s < a.S) {
        kw = *reinterpret_cast<const uint4*>(a.k + kv * a.k_skv + s * a.k_ss + d);
        vw = *reinterpret_cast<const uint4*>(a.v + kv * a.v_skv + s * a.v_ss + d);
      }
      const __nv_bfloat16* kb16 = reinterpret_cast<const __nv_bfloat16*>(&kw);
      const __nv_bfloat16* vb16 = reinterpret_cast<const __nv_bfloat16*>(&vw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        KsT[(d + j) * kKStride + c] = __bfloat162float(kb16[j]);
        Vs[c * kMaxD + d + j] = __bfloat162float(vb16[j]);
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 k4 =
          *reinterpret_cast<const float4*>(&KsT[d * kKStride + tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty * 4 + i) * kQStride + d];
        s[i][0] = fmaf(qv, k4.x, s[i][0]);
        s[i][1] = fmaf(qv, k4.y, s[i][1]);
        s[i][2] = fmaf(qv, k4.z, s[i][2]);
        s[i][3] = fmaf(qv, k4.w, s[i][3]);
      }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kb * kBK + tx * 4 + j;
        live[j] = valid[i] && key < a.S && key <= slot[i] &&
                  key >= a.mask_from &&
                  (a.window == 0 || key > slot[i] - a.window);
        s[i][j] = live[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty * 4 + i) * kPStride + tx * 4 + j] = a.pv_f32 ? p : round_bf16(p);
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + half_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha[i];
    if (tx * 8 < D) {
      for (int c = 0; c < kBK; ++c) {
        const float4 v0 = *reinterpret_cast<const float4*>(&Vs[c * kMaxD + tx * 8]);
        const float4 v1 =
            *reinterpret_cast<const float4*>(&Vs[c * kMaxD + tx * 8 + 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[(ty * 4 + i) * kPStride + c];
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }

  if (tx * 8 >= D) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!valid[i]) continue;
    const int r = ty * 4 + i, t = qb * BQ + r % BQ;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = a.out + kv * a.o_skv + (r / BQ) * a.o_srep + t * a.o_st + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = acc[i][j] * inv;
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`, strides are in
// elements (the head axis D contiguous), `stream` is the caller's
// cudaStream_t. q f32 [KV][rep][T][D] and out f32 likewise through their
// strides; k and v bf16 [KV][S][D] through theirs. Every row of k and v
// starts 16-byte aligned (D and the strides multiples of 8). Returns the
// CUDA error of the launch (0 = none).
int effort_flash_attention(const float* q, long long q_skv, long long q_srep,
                           long long q_st, const void* k, long long k_skv,
                           long long k_ss, const void* v, long long v_skv,
                           long long v_ss, float* out, long long o_skv,
                           long long o_srep, long long o_st, int KV, int rep,
                           int T, int S, int D, int start_slot,
                           int mask_from, int window, int pv_f32,
                           float scale, int device, void* stream) {
  if (KV < 1 || rep < 1 || rep > kRows || T < 1 || S < 1 || D < 8 ||
      D > kMaxD || D % 8 != 0 || mask_from < 0 || window < 0 ||
      start_slot < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q;
  a.q_skv = q_skv;
  a.q_srep = q_srep;
  a.q_st = q_st;
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.k_skv = k_skv;
  a.k_ss = k_ss;
  a.v_skv = v_skv;
  a.v_ss = v_ss;
  a.out = out;
  a.o_skv = o_skv;
  a.o_srep = o_srep;
  a.o_st = o_st;
  a.rep = rep;
  a.T = T;
  a.S = S;
  a.D = D;
  a.BQ = kRows / rep;
  a.start_slot = start_slot;
  a.mask_from = mask_from;
  a.window = window;
  a.pv_f32 = pv_f32;
  a.scale = scale;
  const dim3 grid((T + a.BQ - 1) / a.BQ, KV);
  flash_kernel<<<grid, kThreads, kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
