// Decode attention over the live rows of a bf16 KV cache (K8), for Hopper,
// sm_90a.
//
// Replaces no TPU kernel: the JAX package's decode attention is XLA
// (effort_tpu/models/transformer.py:205, _attention), and the port ran the
// same arithmetic as plain PyTorch (models/transformer.py _attn_core), which
// widens a layer's whole cache to f32 every step, live or not. What it
// computes, for one query token per slot b and query head h (GQA: query
// head h reads KV head h / rep):
//
//   live(b)  = [lo, hi], hi = min(pos[b], S - 1),
//              lo = max(mask_from[b], 0, pos[b] - window + 1 if window)
//   s[t]     = (q[b, h] . k[b, t, h / rep]) / sqrt(D), f32, t in live(b)
//   out[b,h] = sum_t softmax(s)[t] v[b, t, h / rep], f32
//   a slot with no live position writes 0
//
// pos and mask_from are int32 arrays on the card, one entry a slot, read
// when the kernel runs: a captured launch reads the positions anew at every
// replay, and the host never reads them.
//
// Bound: bytes. Each live row of K and V (2 * D bf16 a KV head) is read
// once, q and out once; about 4 operations a loaded element, far under the
// card's ratio of operations to bytes, so no tensor cores: K and V are
// widened to f32 in registers (exact) and every product and sum is f32.
//
// Design (flash-decoding). The grid is (chunk of positions, slot x KV head x
// head group); a block holds the REPG <= 8 query heads of one group of its
// KV head, so each K/V row it loads serves all of them (rep <= 8: all the
// heads that share the row; a wider rep takes ceil(rep / 8) groups, each
// loading the rows again). A chunk is chunk_tiles tiles of TR rows; the
// wrapper sizes the chunks from (B, KV, S) at launch (decode_plan), short
// for one slot so its few heads still fill the card, longer for many
// slots. A block whose chunk lies outside its slot's live range exits at
// once, so the rows read are the live ones.
//   At decode sizes the kernel is bound by latency more than by bytes, so
//   the 8 warps of a block work on their own until the chunk's end, with no
//   barrier inside the loop over tiles:
//   - A warp's rows of each tile (RPW rows a step, every 8th step of the
//     tile) come into its own two-stage shared-memory ring by cp.async (16
//     bytes a copy), the next tile in flight while this one is computed. A
//     row outside the live range, and the columns past D, are zero-filled,
//     not read.
//   - Scores: LPR lanes a row (8 elements each), q in registers, the dot's
//     parts meet by shuffles. The scale 1 / sqrt(D) and log2(e) are one
//     multiply, so the softmax is in base 2 (exp2f).
//   - The warp's online softmax over its rows (running max from -inf,
//     masked scores -inf), and P V into the lane's output columns of every
//     head.
//   - At the chunk's end the warps' maxima, sums and outputs meet in shared
//     memory. A slot and head group whose live range lies in one chunk is
//     written by its block. Otherwise each block writes its partial (max,
//     sum, output) to scratch, and the last block of the (slot, head group)
//     to arrive (a ticket, as K1's selection, taken by an atomic that
//     releases the block's partial and acquires the others') combines them
//     in chunk order and sets the ticket back to 0. The wrapper keeps one
//     array of tickets a (card, stream): calls on one CUDA stream run in
//     order, and each launch is on the caller's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kMaxRepG = 8;    // query heads a block
constexpr int kMaxParts = 128; // chunks a slot (the combine's serial loop)

// rows a tile for heads up to D2 (a power of 2) wide: 8192 elements a tile
// and side, at most 128 rows, and at least a warp step of each warp's
// (kThreads * 8 / D2)
__host__ __device__ constexpr int tile_rows(int D2) {
  return (D2 >= 64 ? 8192 / D2 : 128) > kThreads * 8 / D2
             ? (D2 >= 64 ? 8192 / D2 : 128)
             : kThreads * 8 / D2;
}

// dynamic shared memory: each warp's ring (two stages of its rows of a K
// and a V tile), whose bytes then hold the warps' outputs (kWarps * D2 f32
// a head) and their weights (kWarps a head)
__host__ __device__ constexpr int smem_bytes(int REPG, int D2) {
  return 2 * 2 * tile_rows(D2) * D2 * 2 > (kWarps * D2 + kWarps) * REPG * 4
             ? 2 * 2 * tile_rows(D2) * D2 * 2
             : (kWarps * D2 + kWarps) * REPG * 4;
}

struct Args {
  const float* q;
  long long q_sb;
  const __nv_bfloat16* k;
  long long k_sb, k_ss, k_skv;
  const __nv_bfloat16* v;
  long long v_sb, v_ss, v_skv;
  float* out;
  long long o_sb;
  const int* pos;
  const int* mask_from;
  int KV, rep, groups, S, D, window, chunk_tiles, n_chunks;
  float scale;           // log2(e) / sqrt(D): scores in base 2
  float* part;           // [gridDim.y][n_chunks][REPG * (2 + D)]
  unsigned int* ticket;  // [gridDim.y], 0 between calls
};

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

// atomic add at gpu scope that releases this thread's prior writes (and,
// after a __syncthreads, the block's) and acquires those released before it
__device__ __forceinline__ unsigned int atom_add_acq_rel(unsigned int* p,
                                                         unsigned int v) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// the two bf16 of a 32-bit word as f32 (exact: a bf16 is the top half of
// its f32), element 0 in the low half
__device__ __forceinline__ void bf16x2_f32(uint32_t w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// CPL output columns from shared memory at p (CPL * 2 bytes aligned)
template <int CPL>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float* x) {
  if constexpr (CPL == 1) {
    x[0] = __uint_as_float(
        (uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
  } else if constexpr (CPL == 2) {
    bf16x2_f32(*reinterpret_cast<const uint32_t*>(p), x);
  } else if constexpr (CPL == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16x2_f32(u.x, x);
    bf16x2_f32(u.y, x + 2);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    bf16x2_f32(u.x, x);
    bf16x2_f32(u.y, x + 2);
    bf16x2_f32(u.z, x + 4);
    bf16x2_f32(u.w, x + 6);
  }
}

template <int REPG, int LPR>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  constexpr int D2 = LPR * 8;       // the head depth, up to a power of 2
  constexpr int TR = tile_rows(D2);
  constexpr int RPW = 32 / LPR;     // rows a warp step
  constexpr int WR = TR / kWarps;   // rows a warp a tile
  constexpr int NS = WR / RPW;      // warp steps a tile
  constexpr int CPL = D2 >= 32 ? D2 / 32 : 1;  // output columns a lane
  constexpr int LCOL = D2 / CPL;    // lanes holding output columns
  static_assert(WR % RPW == 0 && WR >= RPW, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  // a warp's scores of its rows of a tile: [row][head]
  __shared__ __align__(16) float s_s[kWarps][WR * REPG];
  __shared__ float s_m[kWarps][REPG], s_l[kWarps][REPG];
  __shared__ float s_bm[REPG], s_bl[REPG];
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y = blockIdx.y, c = blockIdx.x;
  const int rg = y % a.groups;
  const int g = (y / a.groups) % a.KV;
  const int b = y / (a.groups * a.KV);
  const int nr = min(REPG, a.rep - rg * REPG);  // heads of this block
  const int h0 = g * a.rep + rg * REPG;
  const int D = a.D;
  float* out = a.out + b * a.o_sb + (long long)h0 * D;

  const int p = a.pos[b];
  const int hi = min(p, a.S - 1);
  int lo = max(a.mask_from[b], 0);
  if (a.window > 0) lo = max(lo, p - a.window + 1);
  if (lo > hi) {  // no live position: 0, written by chunk 0's block
    if (c == 0)
      for (int e = tid; e < nr * D; e += kThreads) out[e] = 0.0f;
    return;
  }
  const int CH = a.chunk_tiles * TR;
  const int c_lo = lo / CH, c_hi = hi / CH;
  if (c < c_lo || c > c_hi) return;
  const int n_parts = c_hi - c_lo + 1;
  const int r_begin = max(lo, c * CH), r_end = min(hi, c * CH + CH - 1);
  const int t_first = r_begin / TR;
  const int n_t = r_end / TR - t_first + 1;

  // q of the block's heads: the lane's 8 elements of each
  const int li = lane % LPR, ri = lane / LPR;
  const bool lane_on = li * 8 < D;
  float qr[REPG][8];
#pragma unroll
  for (int r = 0; r < REPG; ++r) {
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (r < nr && lane_on) {
      const float4* src = reinterpret_cast<const float4*>(
          a.q + b * a.q_sb + (long long)(h0 + r) * D + li * 8);
      x0 = src[0];
      x1 = src[1];
    }
    qr[r][0] = x0.x; qr[r][1] = x0.y; qr[r][2] = x0.z; qr[r][3] = x0.w;
    qr[r][4] = x1.x; qr[r][5] = x1.y; qr[r][6] = x1.z; qr[r][7] = x1.w;
  }

  // warp w's rows of tile ti: step j's rows row0 + (j * kWarps + w) * RPW
  // + ri, lane li copying and scoring elements 8 li .. 8 li + 7 of them
  const __nv_bfloat16* kb = a.k + b * a.k_sb + g * a.k_skv;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + g * a.v_skv;
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem) + warp * 2 * 2 * WR * D2;
  auto row_of = [&](int ti, int j) {
    return (t_first + ti) * TR + (j * kWarps + warp) * RPW + ri;
  };
  auto load_tile = [&](int ti, int st) {
    __nv_bfloat16* ks = ring + st * 2 * WR * D2;
    __nv_bfloat16* vs = ks + WR * D2;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int t = row_of(ti, j), rw = j * RPW + ri;
      const bool on = t >= r_begin && t <= r_end && lane_on;
      const long long ko = on ? (long long)t * a.k_ss + li * 8 : 0;
      const long long vo = on ? (long long)t * a.v_ss + li * 8 : 0;
      cp16(smem_u32(ks + rw * D2 + li * 8), kb + ko, on ? 16 : 0);
      cp16(smem_u32(vs + rw * D2 + li * 8), vb + vo, on ? 16 : 0);
    }
  };

  // each warp's online softmax over its rows, on its own: the running max
  // and sum of every head (the same in every lane), and the lane's output
  // columns
  float m[REPG], l[REPG], acc[REPG][CPL];
#pragma unroll
  for (int h = 0; h < REPG; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) acc[h][cc] = 0.0f;
  }
  float* ss = s_s[warp];

  load_tile(0, 0);
  cp_commit();
  for (int ti = 0; ti < n_t; ++ti) {
    if (ti + 1 < n_t) load_tile(ti + 1, (ti + 1) & 1);
    cp_commit();
    cp_wait1();
    __syncwarp();
    const __nv_bfloat16* ks = ring + (ti & 1) * 2 * WR * D2;
    const __nv_bfloat16* vs = ks + WR * D2;
    // scores of the warp's rows: every step's partial dots, then their
    // shuffles, then the stores
    float dot[NS][REPG];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int h = 0; h < REPG; ++h) dot[j][h] = 0.0f;
      if (lane_on) {
        float kf[8];
        load_cols<8>(ks + (j * RPW + ri) * D2 + li * 8, kf);
#pragma unroll
        for (int h = 0; h < REPG; ++h)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            dot[j][h] = fmaf(qr[h][i], kf[i], dot[j][h]);
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int h = 0; h < REPG; ++h)
          dot[j][h] += __shfl_xor_sync(0xffffffffu, dot[j][h], o);
    if (li == 0) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int t = row_of(ti, j);
        const bool live = t >= r_begin && t <= r_end;
#pragma unroll
        for (int h = 0; h < REPG; ++h)
          ss[(j * RPW + ri) * REPG + h] = live ? dot[j][h] * a.scale
                                               : -INFINITY;
      }
    }
    __syncwarp();
    // the new running max of every head; a warp whose rows so far are all
    // dead keeps -inf, and its exponents are taken from 0
    float mt[REPG], mref[REPG];
#pragma unroll
    for (int h = 0; h < REPG; ++h) mt[h] = m[h];
#pragma unroll
    for (int rw = 0; rw < WR; ++rw)
#pragma unroll
      for (int h = 0; h < REPG; ++h) mt[h] = fmaxf(mt[h], ss[rw * REPG + h]);
    float my_ref = 0.0f;  // the reference of the lane's head, lane % REPG
#pragma unroll
    for (int h = 0; h < REPG; ++h) {
      mref[h] = mt[h] == -INFINITY ? 0.0f : mt[h];
      if (lane % REPG == h) my_ref = mref[h];
      const float cr = exp2f(m[h] - mref[h]);
      m[h] = mt[h];
      l[h] *= cr;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) acc[h][cc] *= cr;
    }
    __syncwarp();
    // the probabilities, one exponent a lane at a time (entry e is head
    // e % REPG = lane % REPG)
#pragma unroll
    for (int e = lane; e < WR * REPG; e += 32)
      ss[e] = exp2f(ss[e] - my_ref);
    __syncwarp();
    // P V, the lane's columns
#pragma unroll 4
    for (int rw = 0; rw < WR; ++rw) {
      float vf[CPL];
      if (lane < LCOL) load_cols<CPL>(vs + rw * D2 + lane * CPL, vf);
#pragma unroll
      for (int h = 0; h < REPG; ++h) {
        const float pp = ss[rw * REPG + h];
        l[h] += pp;
        if (lane < LCOL) {
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
            acc[h][cc] = fmaf(pp, vf[cc], acc[h][cc]);
        }
      }
    }
    __syncwarp();
  }

  // the warps' states meet in the free rings: out_w[w][h][D2], then the
  // block's max and sum of every head and each warp's weight
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  float* wsc = red + kWarps * REPG * D2;
  if (lane < LCOL) {
#pragma unroll
    for (int h = 0; h < REPG; ++h)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
        red[(warp * REPG + h) * D2 + lane * CPL + cc] = acc[h][cc];
  }
#pragma unroll
  for (int h = 0; h < REPG; ++h)
    if (lane == h) {
      s_m[warp][h] = m[h];
      s_l[warp][h] = l[h];
    }
  __syncthreads();
  if (tid < REPG) {  // some warp of the block had a live row
    float M = -INFINITY, L = 0.0f;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w][tid]);
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(s_m[w][tid] - M);
      wsc[w * REPG + tid] = f;
      L += f * s_l[w][tid];
    }
    s_bm[tid] = M;
    s_bl[tid] = L;
  }
  __syncthreads();
  if (n_parts == 1) {  // the whole live range: the output
    for (int e = tid; e < nr * D; e += kThreads) {
      const int h = e / D, d = e % D;
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w)
        s = fmaf(wsc[w * REPG + h], red[(w * REPG + h) * D2 + d], s);
      out[e] = s / s_bl[h];
    }
    return;
  }
  // a partial: max, sum, then the unnormalised output of each head
  const int stride = REPG * (2 + D);
  float* mine = a.part + ((long long)y * a.n_chunks + c) * stride;
  for (int e = tid; e < nr * D; e += kThreads) {
    const int h = e / D, d = e % D;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      s = fmaf(wsc[w * REPG + h], red[(w * REPG + h) * D2 + d], s);
    mine[2 * REPG + e] = s;
  }
  if (tid < REPG) {
    mine[tid] = s_bm[tid];
    mine[REPG + tid] = s_bl[tid];
  }
  // the block's writes, released by its ticket; the last block's ticket
  // acquires every other block's
  __syncthreads();
  if (tid == 0)
    s_last = atom_add_acq_rel(a.ticket + y, 1u) == (unsigned)n_parts - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block combines the parts c_lo .. c_hi in chunk order, each
  // entry by an online merge: out = sum_i 2^(m_i - M) o_i / sum_i 2^(m_i -
  // M) l_i, M the running max (the loads do not wait on it)
  const float* parts = a.part + ((long long)y * a.n_chunks + c_lo) * stride;
  for (int e = tid; e < nr * D; e += kThreads) {
    const int h = e / D;
    float M = -INFINITY, L = 0.0f, A = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n_parts; ++i) {
      const float* pt = parts + i * stride;
      const float mi = __ldcg(pt + h), si = __ldcg(pt + REPG + h);
      const float ai = __ldcg(pt + 2 * REPG + e);
      const float mn = fmaxf(M, mi);
      const float fo = exp2f(M - mn), fi = exp2f(mi - mn);
      A = A * fo + ai * fi;
      L = L * fo + si * fi;
      M = mn;
    }
    out[e] = A / L;
  }
  if (tid == 0) a.ticket[y] = 0u;  // for the next call on this stream
}

// Per library and card: whether each instance's shared-memory limit is
// raised (index: log2 REPG, log2 LPR).
static bool smem_set[4][6][64];

template <int REPG, int LPR>
cudaError_t launch(const Args& a, dim3 grid, int device,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes(REPG, LPR * 8);
  int ri = 0, li = 0;
  while ((1 << ri) < REPG) ++ri;
  while ((1 << li) < LPR) ++li;
  bool& set = smem_set[ri][li][device];
  if (!set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<REPG, LPR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set = true;
  }
  decode_kernel<REPG, LPR><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int REPG>
cudaError_t launch_lpr(const Args& a, int lpr, dim3 grid, int device,
                       cudaStream_t stream) {
  switch (lpr) {
    case 1: return launch<REPG, 1>(a, grid, device, stream);
    case 2: return launch<REPG, 2>(a, grid, device, stream);
    case 4: return launch<REPG, 4>(a, grid, device, stream);
    case 8: return launch<REPG, 8>(a, grid, device, stream);
    case 16: return launch<REPG, 16>(a, grid, device, stream);
    default: return launch<REPG, 32>(a, grid, device, stream);
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`, strides are in
// elements (the head axis D contiguous), `stream` is the caller's
// cudaStream_t. q f32 [B][KV * rep * D] and out f32 likewise through their
// slot strides; k and v bf16 [B][S][KV][D] through theirs. q, k, v and out
// rows start 16-byte aligned (D and the strides multiples of 8, q's and
// out's of 4). pos and mask_from: B int32 each on the card. The plan (the
// wrapper's decode_plan): repg query heads a block (1, 2, 4 or 8; rep
// groups of it), tile rows a tile (tile_rows of D rounded up to a power
// of 2), chunk_tiles tiles a chunk, n_chunks chunks covering S (at most
// kMaxParts). part: scratch of B * KV * groups * n_chunks * repg * (2 + D)
// f32 (unused when n_chunks is 1); ticket: B * KV * groups zeros (left
// zero). Returns the CUDA error of the launch (0 = none).
int effort_decode_attention(const float* q, long long q_sb, const void* k,
                            long long k_sb, long long k_ss, long long k_skv,
                            const void* v, long long v_sb, long long v_ss,
                            long long v_skv, float* out, long long o_sb,
                            const int* pos, const int* mask_from, int B,
                            int KV, int rep, int S, int D, int window,
                            int repg, int tile, int chunk_tiles,
                            int n_chunks, float* part, unsigned int* ticket,
                            int device, void* stream) {
  int D2 = 8;
  while (D2 < D) D2 *= 2;
  const int groups = (rep + repg - 1) / repg;
  if (B < 1 || KV < 1 || rep < 1 || S < 1 || D < 8 || D > kMaxD ||
      D % 8 != 0 || window < 0 || !pos || !mask_from || !ticket ||
      repg > kMaxRepG || (repg & (repg - 1)) != 0 || repg < 1 ||
      tile != tile_rows(D2) || chunk_tiles < 1 || n_chunks < 1 ||
      n_chunks > kMaxParts ||
      (long long)n_chunks * chunk_tiles * tile < (long long)S ||
      (n_chunks > 1 && !part) || (long long)B * KV * groups > 65535 ||
      device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q;
  a.q_sb = q_sb;
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_skv = k_skv;
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_skv = v_skv;
  a.out = out;
  a.o_sb = o_sb;
  a.pos = pos;
  a.mask_from = mask_from;
  a.KV = KV;
  a.rep = rep;
  a.groups = groups;
  a.S = S;
  a.D = D;
  a.window = window;
  a.chunk_tiles = chunk_tiles;
  a.n_chunks = n_chunks;
  a.scale = 1.4426950408889634f / sqrtf((float)D);
  a.part = part;
  a.ticket = ticket;
  const dim3 grid(n_chunks, B * KV * groups);
  const int lpr = D2 / 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (repg) {
    case 1: err = launch_lpr<1>(a, lpr, grid, device, st); break;
    case 2: err = launch_lpr<2>(a, lpr, grid, device, st); break;
    case 4: err = launch_lpr<4>(a, lpr, grid, device, st); break;
    default: err = launch_lpr<8>(a, lpr, grid, device, st); break;
  }
  return (int)err;
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
