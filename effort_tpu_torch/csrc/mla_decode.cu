// Decode attention of multi-head latent attention in absorbed form (K9), for
// Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package has no latent attention. DeepSeek-V2
// (arXiv:2405.04434 2.1) caches one row a position and layer: the latent
// c (kv_lora_rank = 512 wide, after its RMS norm) and the shared rotary key
// k_pe (64), 576 bf16 in all. Keys and values of head h are W_UK[h]^T c and
// W_UV[h]^T c; the absorbed form moves W_UK onto the query (q_lat[h] =
// W_UK[h] q_nope[h], in models/mla.py), so every head attends over the same
// rows. What this kernel computes, for one query token per slot b and each of
// the 16 heads h:
//
//   live(b)  = [lo, hi], hi = min(pos[b], S - 1), lo = max(mask_from[b], 0)
//   s[t]     = scale * (q[b, h] . cache[b, t]), f32, t in live(b); q[b, h] =
//              [q_lat | q_pe], 576 wide
//   out[b,h] = sum_t softmax(s)[t] cache[b, t, :512], f32 (the value is the
//              latent itself; W_UV is applied after, in models/mla.py)
//   a slot with no live position writes 0
//
// pos and mask_from are int32 arrays on the card, one entry a slot, read when
// the kernel runs: a captured launch reads the positions anew at every replay.
//
// Bound: a live row is 1152 bytes and takes 16 x (576 + 512) multiply-adds,
// about 30 operations a byte: near the card's f32 ratio of operations to
// bytes outside the tensor cores. Everything is f32 on the CUDA cores (the
// rows widened exactly in registers), so the kernel holds the query and the
// sums in f32, as the plain version does.
//
// Design. Every block holds all 16 heads, so each live row is loaded once
// (the rows of a block's chunk into a two-stage shared-memory ring by
// cp.async, 16 bytes a copy; rows outside the live range zero-filled, not
// read). Warp w owns heads 2w and 2w + 1, lane i the 32-bit words i, i + 32,
// ... of a row (conflict-free): its 18 elements of each of its two queries
// sit in registers, pre-scaled by scale * log2(e) so the softmax is in base
// 2. A tile of 16 rows gives each lane 32 partial dots (16 rows x 2 heads);
// one reduce-scatter of 31 shuffles leaves lane i with the whole score of
// (head i / 16, row i % 16). The warp's online softmax then runs over those
// scores (a head's running max over its 16 lanes), the probabilities pass
// through shared memory, and P V goes into the lane's 16 value columns of
// each head.
//   The live range is cut into chunks on the card, from pos: as many of the
// grid's blocks as the range's 16-row tiles allow, each at least min_tiles
// tiles, so short and long ranges alike fill the card. A range that fits one
// chunk is written by that block. Otherwise each block writes its partial
// (max, sum, unnormalised output of each head: 16 x 514 f32) and a second
// launch, the combine, merges them in chunk order in one pass, each thread
// one output element: a partial is 32 KB, so one block merging them all, as
// K8's ticket does, would read megabytes alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 16;         // 2 a warp
constexpr int kWidth = 576;        // a cache row: latent 512 + rotary 64
constexpr int kValue = 512;        // the latent, which is the value
constexpr int kWords = kWidth / 2;  // 32-bit words a row
constexpr int kTile = 16;          // rows a tile
constexpr int kNS = kWords / 32;   // a lane's words of a row (score)
constexpr int kNV = kValue / 64;   // a lane's words of the value
constexpr int kPart = 2 + kValue;  // a partial's floats a head
constexpr int kMaxChunks = 1024;

struct Args {
  const float* q;
  long long q_sb;
  const __nv_bfloat16* c;
  long long c_sb, c_ss;
  float* out;
  long long o_sb;
  const int* pos;
  const int* mask_from;
  int S, min_tiles;
  float scale;  // softmax scale * log2(e)
  float* part;  // [B][gridDim.x][kHeads][kPart]
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

// the two bf16 of a 32-bit word as f32 (exact), element 0 in the low half
__device__ __forceinline__ void bf16x2_f32(uint32_t w, float& x0, float& x1) {
  x0 = __uint_as_float(w << 16);
  x1 = __uint_as_float(w & 0xffff0000u);
}

// The chunking of slot b's live range [lo, hi] (lo <= hi): its tiles t_lo ..
// t_hi, chunk_tiles tiles a chunk, n_parts chunks (at most `blocks`).
struct Chunks {
  int lo, hi, t_lo, t_hi, chunk_tiles, n_parts;
};

__device__ __forceinline__ Chunks chunks_of(const Args& a, int b,
                                            int blocks) {
  Chunks k;
  k.hi = min(a.pos[b], a.S - 1);
  k.lo = max(a.mask_from[b], 0);
  k.t_lo = k.lo / kTile;
  k.t_hi = k.hi / kTile;
  const int n_t = k.t_hi - k.t_lo + 1;
  k.chunk_tiles = max(a.min_tiles, (n_t + blocks - 1) / blocks);
  k.n_parts = (n_t + k.chunk_tiles - 1) / k.chunk_tiles;
  return k;
}

__global__ void __launch_bounds__(kThreads) mla_chunk_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 ring[2][kTile * kWidth];
  __shared__ float s_p[kThreads / 32][32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, c = blockIdx.x;
  float* out = a.out + b * a.o_sb;
  const Chunks k = chunks_of(a, b, gridDim.x);
  if (k.lo > k.hi) {  // no live position: 0, written by block 0
    if (c == 0)
      for (int e = tid; e < kHeads * kValue; e += kThreads) out[e] = 0.0f;
    return;
  }
  if (c >= k.n_parts) return;
  const int t_first = k.t_lo + c * k.chunk_tiles;
  const int n_t = min(k.t_hi, t_first + k.chunk_tiles - 1) - t_first + 1;
  const int r_begin = max(k.lo, t_first * kTile);
  const int r_end = min(k.hi, (t_first + n_t) * kTile - 1);

  // the warp's two queries: the lane's words j * 32 + lane of each
  const int h0 = 2 * warp;
  float q[2][2 * kNS];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* qh = a.q + b * a.q_sb + (long long)(h0 + h) * kWidth;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      const float2 x =
          *reinterpret_cast<const float2*>(qh + 2 * (j * 32 + lane));
      q[h][2 * j] = x.x * a.scale;
      q[h][2 * j + 1] = x.y * a.scale;
    }
  }

  const __nv_bfloat16* cb = a.c + b * a.c_sb;
  auto load_tile = [&](int ti, int st) {
    const int row0 = (t_first + ti) * kTile;
    for (int e = tid; e < kTile * (kWidth / 8); e += kThreads) {
      const int r = e / (kWidth / 8), piece = e % (kWidth / 8);
      const int t = row0 + r;
      const bool on = t >= r_begin && t <= r_end;
      const long long off = on ? (long long)t * a.c_ss + piece * 8 : 0;
      cp16(smem_u32(&ring[st][r * kWidth + piece * 8]), cb + off,
           on ? 16 : 0);
    }
  };

  // the lane's running max and sum of its head (lane / 16), the output
  // columns of both heads
  const int my_h = lane >> 4, my_r = lane & 15;
  float m = -INFINITY, l = 0.0f;
  float acc[2][2 * kNV];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2 * kNV; ++i) acc[h][i] = 0.0f;
  float* ps = s_p[warp];

  load_tile(0, 0);
  cp_commit();
  for (int ti = 0; ti < n_t; ++ti) {
    if (ti + 1 < n_t) load_tile(ti + 1, (ti + 1) & 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(ring[ti & 1]);
    // partial dots: v[h * 16 + r]
    float v[32];
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        float x0, x1;
        bf16x2_f32(tw[r * kWords + j * 32 + lane], x0, x1);
        d0 = fmaf(q[0][2 * j], x0, d0);
        d0 = fmaf(q[0][2 * j + 1], x1, d0);
        d1 = fmaf(q[1][2 * j], x0, d1);
        d1 = fmaf(q[1][2 * j + 1], x1, d1);
      }
      v[r] = d0;
      v[kTile + r] = d1;
    }
    // reduce-scatter: after the step of offset o a lane keeps the half of
    // its values whose index has bit o as the lane has it, so lane i ends
    // with the sum of index i
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float send = up ? v[i] : v[i + o];
        const float keep = up ? v[i + o] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
    const int t = (t_first + ti) * kTile + my_r;
    const float s = (t >= r_begin && t <= r_end) ? v[0] : -INFINITY;
    float mt = s;
#pragma unroll
    for (int o = 8; o >= 1; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float mn = fmaxf(m, mt);
    const float mref = mn == -INFINITY ? 0.0f : mn;
    const float corr = exp2f(m - mref);
    const float p = exp2f(s - mref);
    m = mn;
    l = l * corr + p;
    const float c0 = __shfl_sync(0xffffffffu, corr, 0);
    const float c1 = __shfl_sync(0xffffffffu, corr, 16);
#pragma unroll
    for (int i = 0; i < 2 * kNV; ++i) {
      acc[0][i] *= c0;
      acc[1][i] *= c1;
    }
    ps[lane] = p;
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float p0 = ps[r], p1 = ps[kTile + r];
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        float x0, x1;
        bf16x2_f32(tw[r * kWords + j * 32 + lane], x0, x1);
        acc[0][2 * j] = fmaf(p0, x0, acc[0][2 * j]);
        acc[0][2 * j + 1] = fmaf(p0, x1, acc[0][2 * j + 1]);
        acc[1][2 * j] = fmaf(p1, x0, acc[1][2 * j]);
        acc[1][2 * j + 1] = fmaf(p1, x1, acc[1][2 * j + 1]);
      }
    }
    __syncthreads();  // the next load refills this stage
  }

  // the sum of each head over its 16 lanes
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float m0 = __shfl_sync(0xffffffffu, m, 0);
  const float m1 = __shfl_sync(0xffffffffu, m, 16);
  const float l0 = __shfl_sync(0xffffffffu, l, 0);
  const float l1 = __shfl_sync(0xffffffffu, l, 16);
  if (k.n_parts == 1) {  // the whole live range: the output
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.0f / (h ? l1 : l0);
      float* oh = out + (h0 + h) * kValue;
#pragma unroll
      for (int j = 0; j < kNV; ++j)
        *reinterpret_cast<float2*>(oh + 2 * (j * 32 + lane)) =
            make_float2(acc[h][2 * j] * inv, acc[h][2 * j + 1] * inv);
    }
    return;
  }
  float* mine =
      a.part + ((long long)b * gridDim.x + c) * kHeads * kPart + h0 * kPart;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* ph = mine + h * kPart;
    if (lane == 0) {
      ph[0] = h ? m1 : m0;
      ph[1] = h ? l1 : l0;
    }
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      *reinterpret_cast<float2*>(ph + 2 + 2 * (j * 32 + lane)) =
          make_float2(acc[h][2 * j], acc[h][2 * j + 1]);
  }
}

// The chunks' partials of slot blockIdx.y merged in chunk order, one output
// element a thread: out = sum_i 2^(m_i - M) a_i / sum_i 2^(m_i - M) l_i, M
// the running max. `blocks`: the chunk kernel's grid width.
__global__ void __launch_bounds__(kThreads) mla_combine_kernel(Args a,
                                                               int blocks) {
  const int b = blockIdx.y;
  const Chunks k = chunks_of(a, b, blocks);
  if (k.lo > k.hi || k.n_parts <= 1) return;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = e / kValue, d = e % kValue;
  const float* pt = a.part + (long long)b * blocks * kHeads * kPart +
                    h * kPart;
  float M = -INFINITY, L = 0.0f, A = 0.0f;
#pragma unroll 4
  for (int i = 0; i < k.n_parts; ++i) {
    const float* pi = pt + (long long)i * kHeads * kPart;
    const float mi = pi[0], li = pi[1], ai = pi[2 + d];
    const float mn = fmaxf(M, mi);
    const float fo = exp2f(M - mn), fi = exp2f(mi - mn);
    A = A * fo + ai * fi;
    L = L * fo + li * fi;
    M = mn;
  }
  a.out[b * a.o_sb + e] = A / L;
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`, strides in elements,
// `stream` the caller's cudaStream_t. q f32 [B][16][576] through its slot
// stride (heads contiguous), out f32 [B][16][512] likewise; cache bf16
// [B][S][576] through its slot and row strides (a row contiguous, rows
// 16-byte aligned). pos and mask_from: B int32 each on the card. blocks:
// the chunk kernel's grid width (chunks a slot at most), min_tiles: the
// fewest 16-row tiles a chunk takes. part: scratch of B * blocks * 16 * 514
// f32 (unused when blocks is 1). scale: the softmax scale. Returns the CUDA
// error of the launches (0 = none).
int effort_mla_decode(const float* q, long long q_sb, const void* cache,
                      long long c_sb, long long c_ss, float* out,
                      long long o_sb, const int* pos, const int* mask_from,
                      int B, int S, float scale, int blocks, int min_tiles,
                      float* part, int device, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || !pos || !mask_from || blocks < 1 ||
      blocks > kMaxChunks || min_tiles < 1 || (blocks > 1 && !part) ||
      c_ss % 8 != 0 || device < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q;
  a.q_sb = q_sb;
  a.c = static_cast<const __nv_bfloat16*>(cache);
  a.c_sb = c_sb;
  a.c_ss = c_ss;
  a.out = out;
  a.o_sb = o_sb;
  a.pos = pos;
  a.mask_from = mask_from;
  a.S = S;
  a.min_tiles = min_tiles;
  a.scale = scale * 1.4426950408889634f;
  a.part = part;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mla_chunk_kernel<<<dim3(blocks, B), kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return (int)err;
  mla_combine_kernel<<<dim3(kHeads * kValue / kThreads, B), kThreads, 0,
                       st>>>(a, blocks);
  return (int)cudaGetLastError();
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
