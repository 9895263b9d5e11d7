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
//   out[t]   = sum_k softmax_live(s[t])[k] v[k], P@V with the
//              probabilities kept to about 24 bits (pv_f32) or rounded to
//              bf16
//   a query with no live key gets 0
//
// with the TPU kernel's online softmax (running max from -1e30, masked
// probabilities 0), so a fully masked row keeps l = 0 and writes 0.
//
// Bound. Q and out are f32 [T, H*D]; K and V are read once per KV head; the
// products are 4*D per live (query head, key) pair. At prefill sizes the
// call is short and latency decides it; the products, which JAX's kernel
// runs on the MXU, run here on the tensor cores.
//
// Design. A block is rw x kw warps (rw row warps of 1, 2 or 4, kw key
// warps of 2 or 4, at most 8 in all, from the wrapper's flash_plan) of
// one KV head. Row warp i owns 16 score rows, block row r = (query head r
// / BQ, query qb*BQ + r % BQ), as the TPU kernel orders its folded rows,
// so each K/V tile a block loads serves all of them. The plan takes the
// most row warps a block that still fill the card, the fewest where none
// does (at T = 64 a block holds 16 rows), then key warps up to 8 warps a
// block: the kw warps of a row warp take the kw consecutive tiles of each
// group of keys, each with its own online softmax, and meet at the end
// through shared memory (the running maxes, then the sums and outputs
// rescaled to the largest), so a key range is walked kw times faster and
// the block's copies are issued by more threads.
//   - Q is rounded to bf16 once into shared memory; K and V stay bf16 and
//     come into a two-stage shared-memory ring by cp.async (16 bytes a
//     copy, keys outside the block's live range and past the cache
//     zero-filled), the next group of tiles in flight while the current
//     one is computed. Rows are padded by 16 bytes, so ldmatrix's 8 rows
//     fall in 8 distinct bank groups; a head depth that is not a multiple
//     of 16 is zero-padded in shared memory.
//   - S = Q K^T is mma.sync m16n8k16 bf16 with f32 accumulate: A (Q) by
//     ldmatrix, B (K^T) by ldmatrix on K's rows as they lie. Every product
//     is exact in f32; only the order of the f32 sums differs from the
//     plain version.
//   - The mask and the online softmax run on the accumulator fragments: a
//     row's max and sum meet over the four lanes that hold it. A
//     probability is exp2((s - m) * log2 e), the difference taken first.
//   - O += P V is mma.sync too, P taken from the score fragments as A and
//     V by ldmatrix.trans. Under pv_f32 P = P_hi + P_mid + P_lo, each bf16
//     (each the rounding residual of the parts before), three products
//     into the f32 accumulators: about 24 bits of P, as f32 holds it. (Two
//     parts, 16 bits, moved the prefill logits of a 4-layer Mistral-width
//     model past chip_smoke.py's kernel-against-plain gate.) Without
//     pv_f32, P rounded to bf16 once, as the plain version rounds it.
// Tiles are 32 keys for heads up to 128 wide, 16 above (registers: the
// accumulators of a 256-wide head are 128 a thread; shared memory: a stage
// holds kw tiles of K and of V). Groups wholly in the
// future, behind the window or before mask_from are skipped: all their
// probabilities are 0, so skipping changes nothing.
//
// Layouts come as element strides (the last axis contiguous), so the
// kernel reads the adapter's Q [T, H*D] f32 and the cache [S, KV, D] bf16
// in place and writes [T, H*D] f32, with no transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;         // warps a block: rw * kw
constexpr int kMaxKW = 4;            // key warps a row warp (2 or 4)
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// keys a tile, for heads up to DMAX wide
__host__ __device__ constexpr int tile_keys(int DMAX) {
  return DMAX <= 128 ? 32 : 16;
}

// the head depth padded to the mma depth of 16, and a shared-memory row:
// that plus 8 elements (16 bytes)
__host__ __device__ __forceinline__ int pad_d(int D) {
  return (D + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int row_elems(int D) {
  return pad_d(D) + 8;
}

// Q's rows, then a two-stage ring of kw tiles of K and V; the key warps'
// maxes, sums and output fragments meet in the same bytes once the ring is
// free (the larger of the two)
__host__ __device__ __forceinline__ int smem_bytes(int rw, int kw, int BK,
                                                   int D) {
  const int ring = 2 * kw * 2 * BK * row_elems(D) * 2;
  const int merge = rw * kw * (D / 8 + 1) * 32 * 16;
  return 16 * rw * row_elems(D) * 2 + (ring > merge ? ring : merge);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four 8x8 b16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8; register j gets matrix j (transposed with
// .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c [16 x 8] f32 += a [16 x 16] bf16 (row) * b [16 x 8] bf16 (col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as packed bf16 (x in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// pack_bf16(x, y), leaving in x and y their rounding residuals (exact)
__device__ __forceinline__ uint32_t split_bf16(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  x -= __bfloat162float(h.x);
  y -= __bfloat162float(h.y);
  return *reinterpret_cast<const uint32_t*>(&h);
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
  int kw;       // key warps a row warp
  float scale;  // D^-0.5
};

// grid (ceil(T / BQ), KV), 32 * rw * kw threads, smem_bytes(rw, kw, BK, D)
// dynamic shared bytes
template <int DMAX>
__global__ void __launch_bounds__(32 * kMaxWarps) flash_kernel(Args a) {
  constexpr int BK = tile_keys(DMAX);
  constexpr int NT = BK / 8;     // key columns of S, in 8s
  constexpr int NK = BK / 16;    // key depth steps of P V
  constexpr int ND = DMAX / 8;   // output columns, in 8s
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int D = a.D, RE = row_elems(D), DP = pad_d(D), d8 = DP / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KW = a.kw, GK = KW * BK;  // key warps; keys a group
  const int rw = warp / KW, kw = warp % KW;
  const int R = blockDim.x / 2 / KW;  // 16 score rows a row warp
  const int kv = blockIdx.y, qb = blockIdx.x, BQ = a.BQ;
  const int n_rows = a.rep * BQ;
  __nv_bfloat16* Qs = smem;                 // [R][RE]
  __nv_bfloat16* ring = smem + R * RE;      // stage: K [GK][RE], V [GK][RE]

  // the keys any row of this block can see
  const int q_min = a.start_slot + qb * BQ;
  const int q_max = a.start_slot + min(qb * BQ + BQ, a.T) - 1;
  int k_lo = a.mask_from;
  if (a.window > 0) k_lo = max(k_lo, q_min - a.window + 1);
  k_lo = max(k_lo, 0);
  const int k_hi = min(q_max, a.S - 1);
  const int g0 = k_lo / GK;
  const int n_groups = k_hi >= k_lo ? k_hi / GK - g0 + 1 : 0;

  // K and V rows of group g into stage st, 16 bytes (chunk ch of key row
  // c) a copy, the thread's (c, ch) stepped by the block's threads without
  // a division; keys outside [k_lo, k_hi] and depth past D arrive as zeros
  const int c_step = blockDim.x / d8, ch_step = blockDim.x % d8;
  auto load_group = [&](int grp, int st) {
    __nv_bfloat16* Ks = ring + st * 2 * GK * RE;
    __nv_bfloat16* Vs = Ks + GK * RE;
    int c = tid / d8, ch = tid % d8;
    while (c < GK) {
      const int s = grp * GK + c, d = ch * 8;
      const bool in = s >= k_lo && s <= k_hi && d < D;
      cp16(smem_u32(Ks + c * RE + d),
           in ? a.k + kv * a.k_skv + (long long)s * a.k_ss + d : a.k,
           in ? 16 : 0);
      cp16(smem_u32(Vs + c * RE + d),
           in ? a.v + kv * a.v_skv + (long long)s * a.v_ss + d : a.v,
           in ? 16 : 0);
      c += c_step;
      ch += ch_step;
      if (ch >= d8) {
        ch -= d8;
        ++c;
      }
    }
  };
  if (n_groups > 0) load_group(g0, 0);
  cp_commit();

  // Q rounded to bf16; rows past the block's and depth past D are 0
  for (int idx = tid; idx < R * d8; idx += blockDim.x) {
    const int r = idx / d8, d = (idx % d8) * 8;
    const int t = qb * BQ + r % BQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < n_rows && t < a.T && d < D) {
      const float4* src = reinterpret_cast<const float4*>(
          a.q + kv * a.q_skv + (r / BQ) * a.q_srep + t * a.q_st + d);
      const float4 x0 = src[0], x1 = src[1];
      x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
      x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
    }
    *reinterpret_cast<uint4*>(Qs + r * RE + d) =
        make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                   pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }

  // this lane's two rows of its row warp's 16: g and g + 8 (the mma's C
  // layout), each with columns 2 t4, 2 t4 + 1 of every 8, and the live
  // keys of each row, [key_lo, key_hi] (empty for rows past the block's)
  const int g = lane >> 2, t4 = lane & 3;
  int key_lo[2], key_hi[2];
  bool valid[2];
  float m[2], l[2], o[ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw * 16 + g + 8 * h, t = qb * BQ + r % BQ;
    const int slot = a.start_slot + t;
    valid[h] = r < n_rows && t < a.T;
    key_lo[h] = max(a.mask_from, a.window > 0 ? slot - a.window + 1 : 0);
    key_hi[h] = valid[h] ? min(slot, a.S - 1) : -1;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // ldmatrix addresses: A (Q) rows, B (K) rows and the V rows of .trans
  const int a_row = rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = kw * BK + (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = kw * BK + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  for (int i = 0; i < n_groups; ++i) {
    if (i + 1 < n_groups) load_group(g0 + i + 1, (i + 1) & 1);
    cp_commit();
    cp_wait1();
    __syncthreads();  // group i (and Q) in shared memory for every warp
    const __nv_bfloat16* Ks = ring + (i & 1) * 2 * GK * RE;
    const __nv_bfloat16* Vs = Ks + GK * RE;
    const int key0 = (g0 + i) * GK + kw * BK;  // this warp's tile
    if (key0 <= k_hi && key0 + BK > k_lo) {    // a tile with live keys
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DMAX / 16; ++kd) {
        if (kd * 16 >= DP) break;
        uint32_t qa[4];
        ldsm_x4(qa, smem_u32(Qs + a_row * RE + kd * 16 + a_col));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, smem_u32(Ks + (np * 16 + k_row) * RE + kd * 16 + k_col));
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }

      // mask, online softmax; s becomes P
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t live = 0u;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + 8 * j + 2 * t4 + e;
            const bool lv = key >= key_lo[h] && key <= key_hi[h];
            float& x = s[j][2 * h + e];
            x = lv ? x * a.scale : kNegInf;
            live |= (lv ? 1u : 0u) << (2 * j + e);
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * h + e];
            x = (live >> (2 * j + e)) & 1u ? exp2f((x - m_new) * kLog2e)
                                           : 0.f;
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = exp2f((m[h] - m_new) * kLog2e);
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[j][2 * h] *= alpha;
          o[j][2 * h + 1] *= alpha;
        }
      }

      // O += P V: the score fragments of keys 16kk.. are the A fragment,
      // in one bf16 part or (pv_f32) three
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t pp[3][4];
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          pp[part][0] = split_bf16(s[2 * kk][0], s[2 * kk][1]);
          pp[part][1] = split_bf16(s[2 * kk][2], s[2 * kk][3]);
          pp[part][2] = split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pp[part][3] = split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DMAX / 16; ++dp) {
          if (dp * 16 >= DP) break;
          uint32_t vf[4];
          ldsm_x4_t(vf, smem_u32(Vs + (kk * 16 + v_row) * RE + dp * 16 +
                                 v_col));
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            if (part > 0 && !a.pv_f32) break;
            mma_bf16(o[2 * dp], pp[part], vf[0], vf[1]);
            mma_bf16(o[2 * dp + 1], pp[part], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // stage i & 1 is read: the next iteration refills it
  }

  // the key warps of a row warp meet: each writes its maxes, sums and
  // output fragments into the ring (free now); key warp kw then finishes
  // the output columns 8j.. with j = kw mod KW, rescaling each key warp's
  // part to the largest max
  const int nd = D / 8;
  float* s_o = reinterpret_cast<float*>(ring);      // [warps][nd][32][4]
  float* s_ml = s_o + (blockDim.x / 32) * nd * 128;  // [warps][32][4]
  float f[kMaxKW][2], inv[2];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    if (j >= nd) break;
    *reinterpret_cast<float4*>(s_o + ((warp * nd + j) * 32 + lane) * 4) =
        make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  *reinterpret_cast<float4*>(s_ml + (warp * 32 + lane) * 4) =
      make_float4(m[0], m[1], l[0], l[1]);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mm = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxKW; ++k)
      if (k < KW) mm = fmaxf(mm, s_ml[((rw * KW + k) * 32 + lane) * 4 + h]);
    l[h] = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxKW; ++k) {
      f[k][h] = 0.f;
      if (k >= KW) continue;
      const float* ml = s_ml + ((rw * KW + k) * 32 + lane) * 4;
      f[k][h] = exp2f((ml[h] - mm) * kLog2e);
      l[h] += ml[2 + h] * f[k][h];
    }
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    if (j >= nd) break;
    if (j % KW != kw) continue;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kMaxKW; ++k) {
      if (k >= KW) break;
      const float4 y = *reinterpret_cast<const float4*>(
          s_o + (((rw * KW + k) * nd + j) * 32 + lane) * 4);
      x[0] += y.x * f[k][0];
      x[1] += y.y * f[k][0];
      x[2] += y.z * f[k][1];
      x[3] += y.w * f[k][1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      const int r = rw * 16 + g + 8 * h, t = qb * BQ + r % BQ;
      float* orow = a.out + kv * a.o_skv + (r / BQ) * a.o_srep + t * a.o_st;
      *reinterpret_cast<float2*>(orow + j * 8 + 2 * t4) =
          make_float2(x[2 * h] * inv[h], x[2 * h + 1] * inv[h]);
    }
  }
}

// Per library and card: whether flash_kernel<DMAX>'s shared-memory limit
// is raised (index: DMAX 128 or 256).
static bool smem_set[2][64];

template <int DMAX>
cudaError_t launch(const Args& a, int KV, int rw, int device,
                   cudaStream_t stream) {
  constexpr int BK = tile_keys(DMAX);
  const int smem = smem_bytes(rw, a.kw, BK, a.D);
  bool& set = smem_set[DMAX == 128 ? 0 : 1][device];
  if (!set) {  // the most any plan of this instance takes
    int most = 0;
    for (int r = 1; r <= 4; r *= 2)
      for (int k = 2; k <= kMaxKW && r * k <= kMaxWarps; k *= 2) {
        const int b = smem_bytes(r, k, BK, DMAX);
        most = b > most ? b : most;
      }
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (err != cudaSuccess) return err;
    set = true;
  }
  const dim3 grid((a.T + a.BQ - 1) / a.BQ, KV);
  flash_kernel<DMAX><<<grid, 32 * rw * a.kw, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`, strides are in
// elements (the head axis D contiguous), `stream` is the caller's
// cudaStream_t. q f32 [KV][rep][T][D] and out f32 likewise through their
// strides; k and v bf16 [KV][S][D] through theirs. Every row of q, k, v and
// out starts 16-byte aligned (D and the strides multiples of 8; q and out
// 16-byte aligned). The launch plan (the wrapper's flash_plan): rw row
// warps (1, 2 or 4) and kw key warps (2 or 4) a block, rw * kw <= 8, BQ
// queries a block, rep * BQ <= 16 * rw.
// Returns the CUDA error of the launch (0 = none).
int effort_flash_attention(const float* q, long long q_skv, long long q_srep,
                           long long q_st, const void* k, long long k_skv,
                           long long k_ss, const void* v, long long v_skv,
                           long long v_ss, float* out, long long o_skv,
                           long long o_srep, long long o_st, int KV, int rep,
                           int T, int S, int D, int rw, int kw, int BQ,
                           int start_slot, int mask_from, int window,
                           int pv_f32, float scale, int device,
                           void* stream) {
  if (KV < 1 || rep < 1 || T < 1 || S < 1 || D < 8 || D > kMaxD ||
      D % 8 != 0 || mask_from < 0 || window < 0 || start_slot < 0 ||
      (rw != 1 && rw != 2 && rw != 4) || (kw != 2 && kw != 4) ||
      rw * kw > kMaxWarps || BQ < 1 || rep * BQ > 16 * rw || device < 0 ||
      device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
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
  a.BQ = BQ;
  a.start_slot = start_slot;
  a.mask_from = mask_from;
  a.window = window;
  a.pv_f32 = pv_f32;
  a.kw = kw;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = D <= 128 ? launch<128>(a, KV, rw, device, st)
                 : launch<256>(a, KV, rw, device, st);
  return (int)err;
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
