// Batched row-prefix effort matmul (bucket_size = 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:391
// _kernel_mxu_batch (entry mxu_matvec_batch, fused_stream.py:506). T slots
// (prefill tokens, or the decode slots of a batch) share one instance e of
// a packed [E*nc+1, G, OBv] value tensor:
//
//   per slot t: the selection of row_prefix.cuh at the slot's own f32
//               effort -> u_t [in] bf16 and the slot's stream length C_t
//   C        = max over slots of C_t (fused_stream.py:437)
//   Y[t, j]  = sum over rows r < C*G of u_t[r] * W_e[r, j], f32
//
// Launches on the caller's stream, no host sync: select_batch_kernel (one
// block per slot: u [T, in], C_t), mma_stream_kernel, and, when the row
// range is split, reduce_batch_kernel.
//
// Bound on this card. The streamed prefix is C*G*row_bytes; the products
// are 2*T*C*G*OB operations. In bf16 on the tensor cores (989 TFLOP/s
// against 3.35 TB/s) the bytes bound the call while T stays below about
// 150 slots for int8 values (75 for bf16, 300 for int4); above, the
// operations do. The TPU kernel ran the product on the MXU (a bf16
// dot_general with f32 accumulation), and so does this one.
//
// Design: the product is taken transposed, Y^T[cols, slots] = W^T[cols,
// rows] * U^T[rows, slots]: output columns are M, slots N (8 to 64 a
// tile), input rows K. One slot tile holds up to 64 slots, so at T <= 64
// each weight byte is read from device memory once and decoded once.
// Every operand is exact in bf16 (int8 values -128..127, int4 -8..7, bf16
// values, u already bf16), so each product is exact in f32 and only the
// order of the f32 sums differs from the plain version.
//
// A block is one warpgroup (4 warps) over 256 output columns and a range
// of input rows: a warp decodes 64 columns, its 16-row slice of four
// m64 tiles. Rows stream through a ring of 64-row tiles in shared memory,
// filled by cp.async (16 bytes a copy, L2 only) while earlier tiles are in
// the tensor cores; a tile holds the weights of the block's columns (rows
// padded by 16 bytes, so the warps' reads hit 32 distinct banks) and u of
// its slots (8 x 16-byte core matrices). Weights are decoded from shared
// memory to bf16 in registers: bf16 by byte permutes, int8 through the
// float 2^23 + x trick (one permute and one add a value), int4 as 0x4300
// | nibble less 136 in packed bf16. Each 16-row step is then four
// wgmma.mma_async m64nNk16 (A from those registers, B = u by shared-memory
// descriptor, f32 accumulators), and the next step's decode runs while
// they do (two A buffers). wgmma rather than mma.sync: it is the card's
// full-rate tensor-core path, and a register-sourced wgmma took no other
// change (its A fragment is mma.sync's, a warp's 16 rows). Up to T = 64
// the products do not set the stream's time; its memory pipeline (the
// weight and u tiles, the partial sums) does. Rows past the block's range
// (which ends at the streamed prefix C*G, C read on the device) are
// zero-filled, u and weights both.
//
// The grid is (slot tiles, column tiles, row splits): slot tiles of one
// weight tile are neighbours in launch order and find it in L2. The live
// rows C*G are cut into `splits` equal ranges of whole 64-row tiles, the
// count chosen by the wrapper (fused_stream.k2_plan) to put enough blocks
// on the card; with one split the blocks write Y themselves, otherwise
// partial [splits, T, width] f32, which reduce_batch_kernel adds in split
// order (no float atomics: two calls give the same bits).

#include "row_prefix.cuh"

namespace {

using namespace row_prefix;

constexpr int kWarps = 4;            // warps a block, across its columns
constexpr int kThreads = 32 * kWarps;
constexpr int kKT = 64;              // rows a ring stage holds
constexpr int kRingWide = 72;        // KB of ring at 32 slots and more
constexpr int kRingNarrow = 56;      // KB of ring below
constexpr int kPad = 16;             // bytes after each weight row

// Bytes of a weight row a thread decodes per 16-row step (8 columns in
// every kind), a warp's (8 threads across) and a block's.
template <int KIND>
struct Geo {
  static constexpr int BPT = KIND == kBf16 ? 16 : (KIND == kInt8 ? 8 : 4);
  static constexpr int WB = 8 * BPT;
  static constexpr int BMB = kWarps * WB;             // 512 / 256 / 128
  static constexpr int WSTRIDE = BMB + kPad;
};

// Ring stages: as many as fit in kRingNarrow KB, or kRingWide KB at 32
// slots and more; at least 3. Small, so that blocks share an SM (int8 at
// 64 slots: two) and hide each other's waits at their stage barriers.
template <int KIND, int NN>
struct Ring {
  static constexpr int STAGE = kKT * Geo<KIND>::WSTRIDE + 8 * NN * 2 * kKT;
  static constexpr int BUDGET = (NN >= 4 ? kRingWide : kRingNarrow) * 1024;
  static constexpr int STAGES = BUDGET / STAGE > 3 ? BUDGET / STAGE : 3;
};

template <int KIND, int NN>
__host__ __device__ constexpr int smem_bytes() {
  return Ring<KIND, NN>::STAGES * Ring<KIND, NN>::STAGE;
}

__global__ void __launch_bounds__(kSelThreads) select_batch_kernel(
    const float* __restrict__ V, int in_dim, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, const float* __restrict__ efforts,
    const float* __restrict__ tables, int G, int nc, float tau,
    __nv_bfloat16* __restrict__ u, int32_t* __restrict__ c_slot,
    float* __restrict__ cutoff) {
  const int t = blockIdx.x;
  select_rows(V + (size_t)t * in_dim, P, stride, probes, stats, scales,
              efforts[t], tables, G, nc, tau, u + (size_t)t * in_dim,
              c_slot + t, cutoff + t);
}

// C = max over slots of C_t (at least 1), by one warp; every lane gets it.
__device__ __forceinline__ int max_len_warp(const int32_t* __restrict__ c_slot,
                                            int T) {
  int c = 1;
  for (int t = threadIdx.x & 31; t < T; t += 32) c = max(c, c_slot[t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    c = max(c, __shfl_xor_sync(0xffffffffu, c, o));
  return c;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Y^T[64 columns, 8NN slots] += A [64 x 16] (registers: each warp's
// m16n8k16 A fragment, rows 16w..16w+15) * B [16 x 8NN] (shared memory,
// slot-major, by descriptor), on the warpgroup's tensor cores.
template <int NN>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a,
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_bf16<1>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<2>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<4>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<8>(float* d, const uint32_t* a,
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of x across the
// asynchronous products.
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// Shared-memory matrix descriptor, no swizzle: 8-row x 16-byte core
// matrices, lbo bytes apart along K and sbo bytes apart along the rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// One int8 byte (already xor 0x80, so x + 128) of word w -> f32 x exactly:
// the bits 0x4B0000(x+128) are 2^23 + x + 128.
template <int J>
__device__ __forceinline__ float i8f(uint32_t w) {
  return __uint_as_float(prmt(w, 0x4B000000u, 0x7650u | J)) - 8388736.f;
}

// Two f32 holding bf16-exact values -> bf16x2 {lo, hi} (the high halves).
__device__ __forceinline__ uint32_t hi_pack(float lo, float hi) {
  return prmt(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// int4 nibble pairs: (p & 0x000f000f) | 0x43004300 is bf16x2 128 + n;
// less 136 gives n - 8.
__device__ __forceinline__ uint32_t nib_pair(uint32_t p) {
  const uint32_t x = (p & 0x000f000fu) | 0x43004300u;
  const uint32_t k136 = 0x43084308u;  // bf16x2 {136, 136}
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The words a thread reads of one weight row per 16-row step.
template <int KIND>
struct RowWords {
  static constexpr int N = Geo<KIND>::BPT / 4;
};

template <int KIND>
__device__ __forceinline__ void load_row(const uint8_t* p, uint32_t* w) {
  if (KIND == kBf16) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else if (KIND == kInt8) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x, w[1] = a.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// The thread's 8 columns of rows a (k even) and b (k + 1), as 8 bf16x2
// {a, b} pairs: out[l] for local column l. Decoded column of l for the
// thread whose bytes start at byte cb of the row: bf16 cb/2 + l; int8
// cb + l; int4 cb + l (l < 4, low nibbles) or row_bytes + cb + l - 4.
template <int KIND>
__device__ __forceinline__ void decode_pairs(const uint32_t* a,
                                             const uint32_t* b,
                                             uint32_t* out) {
  if (KIND == kBf16) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[2 * q] = prmt(a[q], b[q], 0x5410u);
      out[2 * q + 1] = prmt(a[q], b[q], 0x7632u);
    }
  } else if (KIND == kInt8) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t wa = a[q] ^ 0x80808080u, wb = b[q] ^ 0x80808080u;
      out[4 * q + 0] = hi_pack(i8f<0>(wa), i8f<0>(wb));
      out[4 * q + 1] = hi_pack(i8f<1>(wa), i8f<1>(wb));
      out[4 * q + 2] = hi_pack(i8f<2>(wa), i8f<2>(wb));
      out[4 * q + 3] = hi_pack(i8f<3>(wa), i8f<3>(wb));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // byte j of a in byte 0, byte j of b in byte 2
      const uint32_t p = prmt(a[0], b[0], (uint32_t)(j | (j << 4) |
                                                      ((4 + j) << 8) |
                                                      ((4 + j) << 12)));
      out[j] = nib_pair(p);
      out[4 + j] = nib_pair(p >> 4);
    }
  }
}

// The block's tile column (0..255) of local column l for the thread whose
// bytes start at byte lb of the block's bytes: bf16 lb/2 + l; int8 lb + l;
// int4 lb + l for the low nibbles (l < 4), 128 + lb + l - 4 for the high
// ones. Tile column c is decoded column b0/2 + c (bf16), b0 + c (int8),
// b0 + c or row_bytes + b0 + c - 128 (int4), b0 the block's first byte.
template <int KIND>
__device__ __forceinline__ int tile_col(int lb, int l) {
  if (KIND == kBf16) return lb / 2 + l;
  if (KIND == kInt8) return lb + l;
  return l < 4 ? lb + l : Geo<kInt4>::BMB + lb + l - 4;
}

// Block (x, y, z): slots [x*8NN, x*8NN + 8NN), row bytes [y*BMB, y*BMB +
// BMB) and split z of the live rows. Writes out[t*ld + col] for t < T and
// col < ncols (Y itself, or split z's slice of partial).
template <int KIND, int NN>
__global__ void __launch_bounds__(kThreads) mma_stream_kernel(
    const uint8_t* __restrict__ vals, int row_bytes, int G,
    const int32_t* __restrict__ c_slot, int T,
    const __nv_bfloat16* __restrict__ u, int in_dim, int splits,
    float* __restrict__ out, size_t split_stride, int ld, int ncols,
    int32_t* __restrict__ c_out) {
  using Gm = Geo<KIND>;
  constexpr int NS = 8 * NN;
  constexpr int STAGES = Ring<KIND, NN>::STAGES;
  constexpr int WTILE = kKT * Gm::WSTRIDE;
  constexpr int STAGE = Ring<KIND, NN>::STAGE;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int CG = max_len_warp(c_slot, T) * G;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    c_out[0] = CG / G;
  const int tiles_all = (CG + kKT - 1) / kKT;
  const int tiles_per = (tiles_all + splits - 1) / splits;
  const int r0 = blockIdx.z * tiles_per * kKT;
  const int r1 = min(r0 + tiles_per * kKT, CG);
  const int n_tiles = r1 > r0 ? (r1 - r0 + kKT - 1) / kKT : 0;
  const int t0 = blockIdx.x * NS;
  const int b0 = blockIdx.y * Gm::BMB;
  const uint32_t s_base = smem_addr(smem);

  // stage s <- rows [r0 + it*kKT, +kKT) of the block's bytes and slots
  auto load = [&](int it, int s) {
    const int rt = r0 + it * kKT;
    const uint32_t sw = s_base + s * STAGE;
    constexpr int WCH = kKT * Gm::BMB / 16;
#pragma unroll
    for (int i = tid; i < WCH; i += kThreads) {
      const int rr = i / (Gm::BMB / 16), cc = (i % (Gm::BMB / 16)) * 16;
      const int r = rt + rr, cbyte = b0 + cc;
      const bool ok = r < r1 && cbyte < row_bytes;
      cp16(sw + rr * Gm::WSTRIDE + cc,
           ok ? vals + (size_t)r * row_bytes + cbyte : vals, ok ? 16 : 0);
    }
    const uint32_t su = sw + WTILE;
    uint8_t* su_p = smem + s * STAGE + WTILE;
    for (int i = tid; i < NS * (kKT / 8); i += kThreads) {
      const int sl = i / (kKT / 8), kk = (i % (kKT / 8)) * 8;
      const int t = t0 + sl, r = rt + kk;
      const size_t off = (size_t)t * in_dim + r;
      // core matrix (sl / 8, kk / 8): 8 slots x 8 rows, 16 bytes a slot
      const int cm = ((sl >> 3) * (kKT / 8) + (kk >> 3)) * 128 + (sl & 7) * 16;
      // u is 0 past the block's rows (the zero-filled weights there are
      // not all 0: an int4 byte 0 decodes to -8)
      if (t < T && r + 8 <= r1 && (off & 7) == 0) {
        cp16(su + cm, u + off, 16);
      } else {
        // a ragged or unaligned piece of u: element by element
        uint16_t* d = reinterpret_cast<uint16_t*>(su_p + cm);
        const uint16_t* src = reinterpret_cast<const uint16_t*>(u);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = (t < T && r + e < r1) ? src[off + e] : (uint16_t)0;
      }
    }
  };

  float acc[4][NN][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_commit();
  }
  const int wbyte = warp * Gm::WB + g * Gm::BPT;   // in the block's bytes
  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile it has landed; the slot refilled below is free
    if (it + STAGES - 1 < n_tiles)
      load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_commit();
    const uint8_t* sw = smem + (it % STAGES) * STAGE;
    const uint32_t su = s_base + (it % STAGES) * STAGE + WTILE;
    // each 16-row step: the warp's weight words from shared memory, decoded
    // to bf16 A fragments, then four m64 products on the warpgroup's
    // tensor cores; the next step decodes while they run (two A buffers)
    constexpr int NKS = kKT / 16;
    constexpr int NW = RowWords<KIND>::N;
    uint32_t raw[NKS][4][NW];
#pragma unroll
    for (int q = 0; q < NKS; ++q) {
      const uint8_t* row = sw + (q * 16 + 2 * tq) * Gm::WSTRIDE + wbyte;
      load_row<KIND>(row, raw[q][0]);
      load_row<KIND>(row + Gm::WSTRIDE, raw[q][1]);
      load_row<KIND>(row + 8 * Gm::WSTRIDE, raw[q][2]);
      load_row<KIND>(row + 9 * Gm::WSTRIDE, raw[q][3]);
    }
    uint32_t a[2][4][4];
#pragma unroll
    for (int q = 0; q < NKS; ++q) {
      uint32_t lo[8], hi[8];
      decode_pairs<KIND>(raw[q][0], raw[q][1], lo);
      decode_pairs<KIND>(raw[q][2], raw[q][3], hi);
      if (q >= 1) wgmma_wait<1>();   // step q - 2's products read a[q & 1]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // m64 tile i, this warp's rows: row g is local column 2i, row g + 8
        // column 2i + 1; k 2tq, 2tq+1 from lo, k 2tq+8, 2tq+9 from hi
        a[q & 1][i][0] = lo[2 * i];
        a[q & 1][i][1] = lo[2 * i + 1];
        a[q & 1][i][2] = hi[2 * i];
        a[q & 1][i][3] = hi[2 * i + 1];
      }
      wgmma_fence();
      const uint64_t desc = smem_desc(su + q * 2 * 128, 128, kKT / 8 * 128);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wgmma_bf16<NN>(&acc[i][0][0], a[q & 1][i], desc);
      wgmma_commit();
    }
    wgmma_wait<0>();  // the stage is read before the barrier frees it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[i][j][e]);
  }
  cp_wait<0>();
  // The block's sums [8NN slots][256 columns] meet in shared memory (the
  // ring is idle by then), and the block writes whole rows of columns,
  // coalesced.
  constexpr int TS = 257;   // floats a slot row (odd: fewer bank conflicts)
  static_assert(NS * TS * 4 <= smem_bytes<KIND, NN>(),
                "the ring holds the block's sums");
  float* tile = reinterpret_cast<float*>(smem);
  __syncthreads();          // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tile_col<KIND>(wbyte, 2 * i + h);
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tile[(j * 8 + 2 * tq + e) * TS + c] = acc[i][j][2 * h + e];
    }
  __syncthreads();
  float* o = out + (size_t)blockIdx.z * split_stride;
  const int nt = min(NS, T - t0);
  for (int i = tid; i < nt * 256; i += kThreads) {
    const int sl = i >> 8, c = i & 255;
    const int byte = KIND == kBf16 ? 2 * c : (KIND == kInt8 ? c : c & 127);
    const int col = KIND == kBf16 ? b0 / 2 + c
                  : (KIND == kInt8 || c < 128 ? b0 + c
                                              : row_bytes + b0 + c - 128);
    if (b0 + byte < row_bytes && col < ncols)
      o[(size_t)(t0 + sl) * ld + col] = tile[sl * TS + c];
  }
}

// Y[t, j] = the sum of partial[sp][t][j] over the splits, in split order.
__global__ void reduce_batch_kernel(const float* __restrict__ partial,
                                    int width, int out_dim, int T,
                                    int splits, float* __restrict__ y) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (j >= out_dim) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    s += partial[((size_t)sp * T + t) * width + j];
  y[(size_t)t * out_dim + j] = s;
}

template <int KIND, int NN>
cudaError_t launch_stream(const uint8_t* vals, int row_bytes, int G,
                          const int32_t* c_slot, int T,
                          const __nv_bfloat16* u, int in_dim, int splits,
                          float* out, size_t split_stride, int ld, int ncols,
                          int32_t* c_out, cudaStream_t st) {
  constexpr int smem = smem_bytes<KIND, NN>();
  static bool ready = false;  // the attribute is set once per process
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        mma_stream_kernel<KIND, NN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((T + 8 * NN - 1) / (8 * NN),
                  (row_bytes + Geo<KIND>::BMB - 1) / Geo<KIND>::BMB, splits);
  mma_stream_kernel<KIND, NN><<<grid, kThreads, smem, st>>>(
      vals, row_bytes, G, c_slot, T, u, in_dim, splits, out, split_stride,
      ld, ncols, c_out);
  return cudaSuccess;
}

template <int KIND>
cudaError_t launch_kind(int nn, const uint8_t* vals, int row_bytes, int G,
                        const int32_t* c_slot, int T, const __nv_bfloat16* u,
                        int in_dim, int splits, float* out,
                        size_t split_stride, int ld, int ncols,
                        int32_t* c_out, cudaStream_t st) {
#define K2_LAUNCH(N)                                                        \
  return launch_stream<KIND, N>(vals, row_bytes, G, c_slot, T, u, in_dim,  \
                                splits, out, split_stride, ld, ncols, c_out, \
                                st)
  switch (nn) {
    case 1: K2_LAUNCH(1);
    case 2: K2_LAUNCH(2);
    case 4: K2_LAUNCH(4);
    default: K2_LAUNCH(8);
  }
#undef K2_LAUNCH
}

}  // namespace

extern "C" {

// Blocks of the stream for value kind `kind` and nn n8 slot tiles that
// one SM of card `device` holds at once (0 on a CUDA error), or -1 when
// block_bytes and tile_rows, the caller's plan (fused_stream.k2_plan), are
// not the kernel's row bytes of a block and rows of a ring stage.
int effort_mxu_batch_blocks_per_sm(int kind, int nn, int block_bytes,
                                   int tile_rows, int device) {
  const int bmb = kind == kBf16 ? Geo<kBf16>::BMB
                                : (kind == kInt8 ? Geo<kInt8>::BMB
                                                 : Geo<kInt4>::BMB);
  if (block_bytes != bmb || tile_rows != kKT) return -1;
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  int n = 0;
#define K2_OCC(K, N)                                                     \
  if (kind == K && nn == N &&                                            \
      cudaFuncSetAttribute(mma_stream_kernel<K, N>,                      \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                           smem_bytes<K, N>()) == cudaSuccess)           \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                       \
        &n, mma_stream_kernel<K, N>, kThreads, smem_bytes<K, N>());
  K2_OCC(kBf16, 1) K2_OCC(kBf16, 2) K2_OCC(kBf16, 4) K2_OCC(kBf16, 8)
  K2_OCC(kInt8, 1) K2_OCC(kInt8, 2) K2_OCC(kInt8, 4) K2_OCC(kInt8, 8)
  K2_OCC(kInt4, 1) K2_OCC(kInt4, 2) K2_OCC(kInt4, 4) K2_OCC(kInt4, 8)
#undef K2_OCC
  return n;
}

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t on that card. V [T, in_dim] f32 (permuted rows),
// efforts [T] f32, u [T, in_dim] bf16, c_slot/cutoff [T], c_out [1],
// y [T, out_dim] f32; nn (1, 2, 4 or 8) n8 tiles of slots a block; splits
// >= 1 row ranges, and with splits > 1 partial [splits, T, width] f32
// (width = decoded columns). Returns the CUDA error of the launches (0 =
// none).
int effort_mxu_matvec_batch(const float* V, int T, const float* probes,
                            const float* stats, const float* scales,
                            const float* efforts, const float* tables,
                            const void* vals, int kind, int in_dim,
                            int row_bytes, int out_dim, int G, int nc, int P,
                            int stride, float tau, int nn, int splits,
                            int width, void* u, int32_t* c_slot,
                            float* cutoff, int32_t* c_out, float* partial,
                            float* y, int device, void* stream) {
  if (!select_fits(P, G, nc) || kind < 0 || kind > 2 || T < 1 ||
      T > 65535 || row_bytes % 16 != 0 || splits < 1 || splits > 65535 ||
      (nn != 1 && nn != 2 && nn != 4 && nn != 8) ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* ub = static_cast<__nv_bfloat16*>(u);
  select_batch_kernel<<<T, kSelThreads, 0, st>>>(
      V, in_dim, P, stride, probes, stats, scales, efforts, tables, G, nc,
      tau, ub, c_slot, cutoff);
  const uint8_t* vb = static_cast<const uint8_t*>(vals);
  float* out = splits > 1 ? partial : y;
  const size_t split_stride = (size_t)T * width;
  const int ld = splits > 1 ? width : out_dim;
  const int ncols = splits > 1 ? width : out_dim;
  if (kind == kBf16)
    err = launch_kind<kBf16>(nn, vb, row_bytes, G, c_slot, T, ub, in_dim,
                             splits, out, split_stride, ld, ncols, c_out, st);
  else if (kind == kInt8)
    err = launch_kind<kInt8>(nn, vb, row_bytes, G, c_slot, T, ub, in_dim,
                             splits, out, split_stride, ld, ncols, c_out, st);
  else
    err = launch_kind<kInt4>(nn, vb, row_bytes, G, c_slot, T, ub, in_dim,
                             splits, out, split_stride, ld, ncols, c_out, st);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1)
    reduce_batch_kernel<<<dim3((out_dim + 255) / 256, T), 256, 0, st>>>(
        partial, width, out_dim, T, splits, y);
  return (int)cudaGetLastError();
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
