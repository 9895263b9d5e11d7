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
// K4's selection (effort_tpu/kernels/fused_stream.py:_kernel, :157-186),
// on the 16.16 effort, is spread over a grid of blocks of kSelThreads
// threads, each owning a run of whole chunks (fused_matvec.cu):
//   cutoff  = row_prefix::find_cutoff (the same search and table as K1),
//             found by every block on the same probes, so the same bits
//   n_i     = #{k < K : stats[i, k] * |v_i| > cutoff}          (rank_rows)
//   u[k, i] = v_i * [k < n_i] * scale[i, k]                 (f32, not bf16)
//   mass    = each (rank, chunk)'s selected mass in f64, summed inside the
//             owning block and stored with plain stores (no atomics across
//             blocks, nothing to zero)
//   C_k     = shortest chunk prefix holding tau of rank k's selected mass,
//             each prefix rounded to f32 once (rank_scan, run by the last
//             block to finish)
//   tiles   = ceil(C_k / TGB) per rank; cum_tiles [K+1], base_blocks [K]
// The f64 sums are exact, so neither their order nor the split of the
// chunks over blocks changes a bit of C_k.
//
// ring_stream_kernel() is the stream K4 and K5 share. It is bound by the
// bytes it streams: tile t of the flattened per-rank prefixes (TGB chunks
// of one rank, rounded-up tail included) is cut into ring stages of
// kStageRows rows. One lane of a producer warp asks the copy engine (TMA)
// for each stage as a few 2-D boxes, kStageRows rows of the block's value
// bytes of each value group and of its position bytes, completing on the
// stage's mbarrier, and keeps every free stage of a ring in shared memory
// in flight while four consumer warps compute on the stages that have
// landed. The tensor maps (vals and pos as [blocks * G, row bytes] bytes)
// are encoded on the host each call, through the runtime's driver entry
// point (CUDA 12.5 or later). The ring's parts (Ring's stage layout,
// stage_boxes, scatter_row, write_sums) also make K6's and K7's gather
// (block_gather.cuh), whose stages are one gathered block each.
//
// Work is split over (column block, split). A lane owns NBT consecutive
// position bytes and so NBT * (8/bits) columns, B accumulators each, 64 in
// all; the block's four consumer warps take every fourth row of a tile for
// the same 32 lanes' columns, and add their sums in warp order at the end;
// a split walks tiles split, split + S, ... and writes its partial sums;
// reduce_splits adds the live splits in split order. No atomics: a
// rerun gives the same bits. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: no fused multiply-add) and the order is fixed, so
// the plain versions (kernels/prefix_stream.split_sum) repeat it bit for
// bit.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "row_prefix.cuh"

namespace rank_prefix {

using row_prefix::kBf16;
using row_prefix::kInt4;
using row_prefix::kInt8;
using row_prefix::kSelThreads;

constexpr int kMaxRanks = 32;
constexpr int kRowWarps = 4;         // warps of a block, one row in 4 each
constexpr int kThreads = 32 * kRowWarps;
constexpr int kMaxMasses = 24576;    // K * nc f64 masses of K4's selection
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

// ---- the ring (K4's and K5's stream, K6's and K7's gather) ----------------

constexpr int kStageRows = 32;        // rows of a stream stage (of a box)
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 72 * 1024;  // ring bytes: three blocks an SM
constexpr int kRingThreads = kThreads + 32;  // + the producer warp
constexpr int kMaxBoxBytes = 256;     // the copy engine's widest box row
constexpr int kMaxBoxes = 17;         // boxes a stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The producer's arrival on *bar, which also expects `bytes` more bytes
// from the copy engine before the phase can complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of *bar has completed. A phase
// that has not completed after ~2^34 cycles (seconds) can only be a fault:
// the kernel traps, and the launch reports an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// A box of the 2-D row-major byte tensor *map (rows of row_bytes), columns
// x .. x + box width - 1 of rows y .. y + box rows - 1 (encode_rows), into
// shared memory at dst (128-aligned) by the copy engine; columns or rows
// outside the tensor arrive as zeros. Completion counts the box's bytes
// against *bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// NB bytes of shared memory at p (aligned to min(NB, 16)) as 32-bit words.
template <int NB>
__device__ __forceinline__ void lds_bytes(const uint8_t* p, uint32_t* w) {
  if constexpr (NB >= 16) {
    static_assert(NB % 16 == 0, "a multiple of 16 bytes");
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(NB == 2, "2, 4, 8 or a multiple of 16 bytes");
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

// Bytes a box of rows x bytes takes in a stage: rounded up to 128, where
// the copy engine's boxes land.
__host__ __device__ constexpr int part_bytes(int rows, int bytes) {
  return (rows * bytes + 127) / 128 * 128;
}

// The stages of stage_bytes that fit the ring budget, 2 to kMaxStages.
__host__ __device__ constexpr int ring_stages(int stage_bytes) {
  return kRingBudget / stage_bytes > kMaxStages
             ? kMaxStages
             : (kRingBudget / stage_bytes < 2 ? 2
                                              : kRingBudget / stage_bytes);
}

// A ring kernel's dynamic shared bytes for a ring of ring_bytes: the ring
// also holds the consumer warps' sums at the end (write_sums); 128 bytes
// to align it.
__host__ __device__ constexpr int ring_smem(int ring_bytes) {
  return 128 + (ring_bytes > kRowWarps * kAccs * 32 * 4
                    ? ring_bytes
                    : kRowWarps * kAccs * 32 * 4);
}

// What a block of a ring kernel stages, a stage of `rows` rows (the
// stream's kStageRows, or a gathered block's G): for each value group t
// (columns t*prow + jb, t < PB) a slab of rows x its 32 lanes' value bytes
// (lane l at l*VB), int4 a second slab for the high-nibble lanes; then a
// slab of the lanes' position bytes (lane l at l*NBT). A slab row wider
// than the copy engine's widest box (kMaxBoxBytes: K7's, one position
// byte a column) is cut into parts of that width, lane l's bytes in part
// l*VB / kVPart. Each part of a slab is one box and starts on 128 bytes.
template <int KIND, int B, class P = PackedPos<B>>
struct Ring {
  using Pos = P;
  static constexpr int kPB = Pos::kPerByte;
  static constexpr int kNBT = Owned<B, Pos>::kNBT;
  static constexpr int kVB = KIND == kBf16 ? 2 * kNBT : kNBT;
  static constexpr int kVBox = 32 * kVB;   // bytes a row of a value slab
  static constexpr int kPBox = 32 * kNBT;  // bytes a row of the position slab
  static constexpr int kVPart = kVBox < kMaxBoxBytes ? kVBox : kMaxBoxBytes;
  static constexpr int kPPart = kPBox < kMaxBoxBytes ? kPBox : kMaxBoxBytes;
  static constexpr int kVParts = kVBox / kVPart, kPParts = kPBox / kPPart;
  static constexpr int kVSlabs = KIND == kInt4 ? 2 * kPB : kPB;
  static_assert(kVSlabs * kVParts + kPParts <= kMaxBoxes, "boxes a stage");

  // the position slab's offset in a stage of `rows` rows, a stage's
  // bytes, the ring's stages and the kernel's dynamic shared bytes
  __host__ __device__ static constexpr int pslab(int rows) {
    return kVSlabs * kVParts * part_bytes(rows, kVPart);
  }
  __host__ __device__ static constexpr int stage_bytes(int rows) {
    return pslab(rows) + kPParts * part_bytes(rows, kPPart);
  }
  __host__ __device__ static constexpr int stages(int rows) {
    return ring_stages(stage_bytes(rows));
  }
  __host__ __device__ static constexpr int smem(int rows) {
    return ring_smem(stages(rows) * stage_bytes(rows));
  }
  // the stream's (kStageRows rows)
  static constexpr int kPSlab = kVSlabs * kVParts *
                                part_bytes(kStageRows, kVPart);
  static constexpr int kStageBytes =
      kPSlab + kPParts * part_bytes(kStageRows, kPPart);
  static constexpr int kStages = ring_stages(kStageBytes);
  static constexpr int kSmem = ring_smem(kStages * kStageBytes);

  // lane `lane`'s bytes of row q of value slab s, and of the position
  // slab, in a stage st of `rows` rows
  __device__ static __forceinline__ const uint8_t* vbytes(const uint8_t* st,
                                                          int rows, int s,
                                                          int q, int lane) {
    const int off = lane * kVB;
    return st + (s * kVParts + off / kVPart) * part_bytes(rows, kVPart) +
           q * kVPart + off % kVPart;
  }
  __device__ static __forceinline__ const uint8_t* pbytes(const uint8_t* st,
                                                          int rows, int q,
                                                          int lane) {
    const int off = lane * kNBT;
    return st + pslab(rows) + (off / kPPart) * part_bytes(rows, kPPart) +
           q * kPPart + off % kPPart;
  }
};

// Whether part j (w bytes a row) of a slab holds bytes of any of lanes l0
// .. l1 - 1 (lb bytes each).
__device__ __forceinline__ bool holds(int j, int w, int l0, int l1, int lb) {
  return l1 > l0 && j * w < l1 * lb && (j + 1) * w > l0 * lb;
}

// The boxes of a stage of `rows` rows for column block bx, value boxes
// first: {x, offset in the stage, map (0 values, 1 positions)}. Value group
// t's live lanes (columns < OB) take the parts of slab t that hold their
// bytes, from byte x = c (bf16: 2c) on, c lane 0's first column; int4's
// high-nibble lanes (columns >= half) the parts of slab kPB + t from x = c
// - half (x < 0 where the group straddles half: those bytes arrive as zeros
// and belong to low-nibble lanes, which read slab t); the positions the
// parts of their slab from x = jb. Returns the count; *bytes the stage's
// bytes.
template <int KIND, int B, class Pos>
__device__ int stage_boxes(int bx, int prow, int half, int OB, int rows,
                           int (*box)[3], uint32_t* bytes) {
  using R = Ring<KIND, B, Pos>;
  constexpr int NBT = R::kNBT, VB = R::kVB, VW = R::kVPart, PW = R::kPPart;
  const int jb = bx * 32 * NBT;  // the block's first position byte
  const int lanes = max(0, min(32, (prow - jb) / NBT));
  const int vpart = part_bytes(rows, VW), ppart = part_bytes(rows, PW);
  int n = 0;
  if (lanes > 0) {
    for (int t = 0; t < R::kPB; ++t) {
      const int c = t * prow + jb;  // lane 0's first column
      const int live = max(0, min(lanes, (OB - c) / NBT));
      const int lo =
          KIND == kInt4 ? max(0, min(live, (half - c) / NBT)) : live;
#pragma unroll
      for (int j = 0; j < R::kVParts; ++j) {
        if (holds(j, VW, 0, lo, VB)) {
          box[n][0] = (KIND == kBf16 ? 2 * c : c) + j * VW;
          box[n][1] = (t * R::kVParts + j) * vpart;
          box[n][2] = 0;
          ++n;
        }
        if (KIND == kInt4 && holds(j, VW, lo, live, VB)) {  // high nibbles
          box[n][0] = c - half + j * VW;
          box[n][1] = ((R::kPB + t) * R::kVParts + j) * vpart;
          box[n][2] = 0;
          ++n;
        }
      }
    }
  }
  const int nv = n;
#pragma unroll
  for (int j = 0; j < R::kPParts; ++j) {
    if (holds(j, PW, 0, lanes, NBT)) {
      box[n][0] = jb + j * PW;
      box[n][1] = R::pslab(rows) + j * ppart;
      box[n][2] = 1;
      ++n;
    }
  }
  *bytes = rows * (nv * VW + (n - nv) * PW);
  return n;
}

// Row q of a stage st of `rows` rows, times uu, into the lane's
// accumulators: acc[(t*NBT + i)*B + p] += uu * W[q, c] (the product rounded,
// then the sum, no fused multiply-add) for each of the lane's live columns
// c = t*prow + jb0 + i, p the column's position. The plain versions add 0
// to the other B-1 accumulators, which leaves them as they are (a sum that
// starts at +0 is never -0), so skipping those adds keeps every bit.
template <int KIND, int B, class Pos>
__device__ __forceinline__ void scatter_row(const uint8_t* st, int rows,
                                            int q, int lane, float uu,
                                            const bool* live, const bool* hi,
                                            float* acc) {
  using R = Ring<KIND, B, Pos>;
  constexpr int PB = R::kPB, NBT = R::kNBT, VB = R::kVB;
  uint32_t pw[(NBT + 3) / 4], vw[PB][(VB + 3) / 4];
  lds_bytes<NBT>(R::pbytes(st, rows, q, lane), pw);
#pragma unroll
  for (int t = 0; t < PB; ++t)
    if (live[t]) lds_bytes<VB>(R::vbytes(st, rows, hi[t] ? PB + t : t, q,
                                         lane),
                               vw[t]);
#pragma unroll
  for (int t = 0; t < PB; ++t) {
    if (!live[t]) continue;
#pragma unroll
    for (int i = 0; i < NBT; ++i) {
      const int p = Pos::at(byte_at(pw, i), t);
      const float x = __fmul_rn(uu, value_at<KIND>(vw[t], i, hi[t]));
      float* a = acc + (t * NBT + i) * B;
#pragma unroll
      for (int pp = 0; pp < B; ++pp)
        if (p == pp) a[pp] = __fadd_rn(a[pp], x);
    }
  }
}

// out[j*B + p] for the block's columns (one split's partial sums): each
// column's kRowWarps consumer warp sums (acc), added in warp order (the
// warps took rows r = w mod kRowWarps). They pass through the ring, which
// is free once every stage is consumed. Every thread of the block calls it.
template <int B, class Pos>
__device__ __forceinline__ void write_sums(const float* acc, uint8_t* ring,
                                           int prow, int OB,
                                           float* __restrict__ out) {
  constexpr int NBT = Owned<B, Pos>::kNBT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // every stage is consumed: the ring is free
  float* s_acc = reinterpret_cast<float*>(ring);  // [kRowWarps][kAccs][32]
  if (warp < kRowWarps) {
#pragma unroll
    for (int i = 0; i < kAccs; ++i)
      s_acc[(warp * kAccs + i) * 32 + lane] = acc[i];
  }
  __syncthreads();
  for (int idx = tid; idx < kAccs * 32; idx += kRingThreads) {
    const int i = idx >> 5, l = idx & 31;
    const int jb = (blockIdx.x * 32 + l) * NBT;
    const int t = i / (NBT * B), c = t * prow + jb + (i / B) % NBT;
    if (jb >= prow || c >= OB) continue;
    float s = s_acc[i * 32 + l];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w)
      s = __fadd_rn(s, s_acc[(w * kAccs + i) * 32 + l]);
    out[(size_t)c * B + i % B] = s;
  }
}

// grid (column blocks, S), kRingThreads threads, Ring::kSmem dynamic
// shared bytes: split y streams tiles y, y + S, ... < cum[K] in ring stages
// of kStageRows rows and writes partial[y][:]; splits past the last tile
// exit at once. Warps 0-3 consume (warp w takes rows r = w mod 4 of each
// tile, in order: scatter_row); one lane of warp 4 produces, asking the
// copy engine for a stage's boxes (vmap over the value rows, pmap over the
// position rows) on the stage's mbarrier.
template <int KIND, int B>
__global__ void __launch_bounds__(kRingThreads, 3) ring_stream_kernel(
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap pmap, int prow, int half,
    const int32_t* __restrict__ cum_tiles,
    const int32_t* __restrict__ base_blocks, const float* __restrict__ u,
    int K, int G, int tgb, int in_dim, int OB,
    float* __restrict__ partial) {
  using R = Ring<KIND, B>;
  using Pos = typename R::Pos;
  constexpr int PB = R::kPB, NBT = R::kNBT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int s_cum[kMaxRanks + 1], s_base[kMaxRanks];
  __shared__ int s_box[kMaxBoxes][3];
  __shared__ int s_nbox;
  __shared__ uint32_t s_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid <= K) s_cum[tid] = cum_tiles[tid];
  if (tid < K) s_base[tid] = base_blocks[tid];
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrival with its bytes
      mbar_init(&empty[s], kRowWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_nbox = stage_boxes<KIND, B, Pos>(blockIdx.x, prow, half, OB,
                                       kStageRows, s_box, &s_bytes);
  }
  __syncthreads();
  const int total = s_cum[K];
  if ((int)blockIdx.y >= total || s_nbox == 0) return;
  const int rows = tgb * G;
  const int per_tile = (rows + kStageRows - 1) / kStageRows;
  const int units = ((total - 1 - (int)blockIdx.y) / (int)gridDim.y + 1) *
                    per_tile;

  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  if (warp == kRowWarps) {
    // producer: stage n goes into slot n % kStages once the consumers
    // have released its previous use
    if (lane == 0) {
      const int nbox = s_nbox;
      const uint32_t bytes = s_bytes;
      for (int n = 0; n < units; ++n) {
        const int slot = n % R::kStages;
        const uint32_t use = n / R::kStages;
        if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
        const int t = blockIdx.y + (n / per_tile) * gridDim.y;
        int k = 0;
        for (int j = 1; j < K; ++j) k += t >= s_cum[j] ? 1 : 0;
        const int row0 = (s_base[k] + (t - s_cum[k]) * tgb) * G +
                         (n % per_tile) * kStageRows;
        uint8_t* st = ring + slot * R::kStageBytes;
        mbar_expect_tx(&full[slot], bytes);
        for (int i = 0; i < nbox; ++i)
          tma_box(st + s_box[i][1], s_box[i][2] ? &pmap : &vmap, s_box[i][0],
                  row0, &full[slot]);
      }
    }
  } else {
    // consumers
    const int jb0 = (blockIdx.x * 32 + lane) * NBT;
    const bool active = jb0 < prow;
    bool live[PB], hi[PB];
#pragma unroll
    for (int t = 0; t < PB; ++t) {
      const int c0 = t * prow + jb0;
      live[t] = active && c0 < OB;
      hi[t] = KIND == kInt4 && c0 >= half;
    }
    // u of the warp's rows q = warp + 4m of stage n: lane m holds row m's,
    // loaded a stage ahead
    auto u_of = [&](int n) {
      const int t = blockIdx.y + (n / per_tile) * gridDim.y;
      const int r0 = (n % per_tile) * kStageRows;
      int k = 0;
      for (int j = 1; j < K; ++j) k += t >= s_cum[j] ? 1 : 0;
      const int q = warp + kRowWarps * lane;
      return (n < units && lane < kStageRows / kRowWarps &&
              q < min(kStageRows, rows - r0))
                 ? u[(size_t)k * in_dim + (size_t)(t - s_cum[k]) * tgb * G +
                     r0 + q]
                 : 0.f;
    };
    float u_next = u_of(0);
    for (int n = 0; n < units; ++n) {
      const int slot = n % R::kStages;
      const int nr = min(kStageRows, rows - (n % per_tile) * kStageRows);
      const float um = u_next;
      u_next = u_of(n + 1);
      mbar_wait(&full[slot], (n / R::kStages) & 1);
      const uint8_t* st = ring + slot * R::kStageBytes;
#pragma unroll 2  // two rows' loads in flight
      for (int m = 0; m < kStageRows / kRowWarps; ++m) {
        const int q = warp + kRowWarps * m;
        if (q >= nr) break;
        const float uu = __shfl_sync(0xffffffffu, um, m);
        if (!active) continue;
        scatter_row<KIND, B, Pos>(st, kStageRows, q, lane, uu, live, hi, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }
  write_sums<B, Pos>(acc, ring, prow, OB,
                     partial + (size_t)blockIdx.y * OB * B);
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

// ---- K4's selection, over a grid of blocks --------------------------------

// One block's share of the selection: rows [row0, row0 + nrows) (whole
// chunks), R consecutive rows a thread (G % R == 0): n_i, u[k, i] (u rows
// in_dim long), and each row's selected mass x = stats[i, k] * |v_i| added
// into s_mass[k * (nrows / G) + its chunk in the run] (zeroed by the
// caller). A thread sums its R rows, a segment of gcd(G / R, 32) lanes
// (inside one chunk) sums by shuffles, and the segment's sum goes in by a
// shared-memory atomic. The f64 sums are exact, so their order does not
// change a bit.
template <int R>
__device__ __forceinline__ void rank_rows(
    const float* __restrict__ v, const float* __restrict__ stats,
    const float* __restrict__ scales, float cutoff, int G, int row0,
    int nrows, int in_dim, int K, float* __restrict__ u, double* s_mass) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = nrows / G;
  int seg = 32;
  while ((G / R) % seg) seg >>= 1;
  for (int j0 = warp * 32; j0 * R < nrows; j0 += kSelThreads) {
    const int r = (j0 + lane) * R;  // the thread's first row in the run
    const bool has = r < nrows;
    const int i0 = row0 + (has ? r : 0);
    float vi[R], av[R];
    int n[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      vi[q] = has ? v[i0 + q] : 0.f;
      av[q] = fabsf(vi[q]);
      n[q] = 0;
    }
    const float* st = stats + (size_t)i0 * K;
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int q = 0; q < R; ++q)
        n[q] += (has && __fmul_rn(st[q * K + k], av[q]) > cutoff) ? 1 : 0;
    for (int k = 0; k < K; ++k) {
      double m = 0.0;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const bool sel = k < n[q];
        if (has) {
          const float ui =
              scales != nullptr
                  ? __fmul_rn(vi[q], scales[(size_t)(i0 + q) * K + k])
                  : vi[q];
          u[(size_t)k * in_dim + i0 + q] = sel ? ui : 0.f;
        }
        if (sel) m += (double)__fmul_rn(st[q * K + k], av[q]);
      }
      for (int o = seg >> 1; o > 0; o >>= 1)
        m += __shfl_xor_sync(0xffffffffu, m, o);
      if (has && (lane & (seg - 1)) == 0)
        atomicAdd(&s_mass[k * nch + r / G], m);
    }
  }
}

// The selection's end, by one block of kSelThreads threads once every
// (rank, chunk) mass is in ms [K][nc] (shared memory). Per rank, one warp
// each: C_k = row_prefix::chunk_prefix_len of the rank's chunk masses (the
// inclusive prefixes in f64, exact in any order, each rounded to f32 once;
// the count below tau * total, plus 1, at most nc). Writes c_out [K],
// cum_tiles [K+1], base_blocks [K] and cutoff_out [1].
__device__ __forceinline__ void rank_scan(
    double* s_mass, int nc, int K, int tgb, float tau, int expert,
    float cutoff, int32_t* __restrict__ c_out,
    int32_t* __restrict__ cum_tiles, int32_t* __restrict__ base_blocks,
    float* __restrict__ cutoff_out) {
  __shared__ int s_len[kMaxRanks];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp < K) {
    const int C = row_prefix::chunk_prefix_len(s_mass + warp * nc, nc, tau);
    if (lane == 0) {
      c_out[warp] = C;
      s_len[warp] = (C + tgb - 1) / tgb;
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

// Per library (namespace-scope `static`: a static local of an inline
// function would be one object across every library of the process, a GNU
// unique symbol): whether ring_stream_kernel<KIND, B>'s shared-memory
// limit is raised, by kind, log2(B) and card, and the driver's
// cuTensorMapEncodeTiled, found through the runtime once.
static bool ring_smem_set[3][6][64];
static PFN_cuTensorMapEncodeTiled_v12000 encode_tiled = nullptr;

constexpr int log2_of(int B) {
  return B == 2 ? 1 : B == 4 ? 2 : B == 8 ? 3 : B == 16 ? 4 : 5;
}

// *map over nrows rows of row_bytes bytes from base (16-aligned, row_bytes
// a multiple of 16), boxes of box_bytes x box_rows. A host-side encoding
// only: no work on the card, no sync.
inline cudaError_t encode_rows(CUtensorMap* map, const uint8_t* base,
                               int row_bytes, int nrows, int box_bytes,
                               int box_rows) {
  if (encode_tiled == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode_tiled = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)nrows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_bytes, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                      const_cast<uint8_t*>(base), dims, strides, box, steps,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The stream's launches on `stream` (K4 after its selection, K5 alone):
// ring_stream_kernel over grid (column blocks, splits), then the split sum
// of the splits that held a tile. Returns the CUDA error (0 = none).
struct StreamLaunch {
  const uint8_t* vals;
  int vrow;
  const uint8_t* pos;
  int prow, half, nrows;  // nrows: rows of vals and pos, blocks * G
  const int32_t* cum_tiles;
  const int32_t* base_blocks;
  const float* u;
  int K, G, tgb, in_dim, OB;
  float* partial;
  dim3 grid;
  int threads;
  cudaStream_t stream;
  int device;
  cudaError_t error;  // of the tensor maps or the shared-memory limit

  template <int KIND, int B>
  void run() {
    using R = Ring<KIND, B>;
    CUtensorMap vmap, pmap;
    error = encode_rows(&vmap, vals, vrow, nrows, R::kVPart, kStageRows);
    if (error == cudaSuccess)
      error = encode_rows(&pmap, pos, prow, nrows, R::kPPart, kStageRows);
    if (error != cudaSuccess) return;
    bool& smem_set = ring_smem_set[KIND][log2_of(B)][device];
    if (!smem_set) {  // the shared-memory limit, raised once a card
      error = cudaFuncSetAttribute(ring_stream_kernel<KIND, B>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   R::kSmem);
      if (error != cudaSuccess) return;
      smem_set = true;
    }
    ring_stream_kernel<KIND, B><<<grid, threads, R::kSmem, stream>>>(
        vmap, pmap, prow, half, cum_tiles, base_blocks, u, K, G, tgb, in_dim,
        OB, partial);
  }
};

inline int stream_matvec(int kind, int B, StreamLaunch& launch, float* y) {
  // the copy engine needs 16-byte aligned rows
  if (launch.K < 1 || launch.K > kMaxRanks ||
      launch.threads != kRingThreads || launch.device < 0 ||
      launch.device >= 64 || (launch.vrow | launch.prow | launch.half) % 16 ||
      (reinterpret_cast<uintptr_t>(launch.vals) |
       reinterpret_cast<uintptr_t>(launch.pos)) % 16)
    return (int)cudaErrorInvalidValue;
  launch.error = cudaSuccess;
  if (!dispatch<true>(kind, B, launch)) return (int)cudaErrorInvalidValue;
  if (launch.error != cudaSuccess) return (int)launch.error;
  const int out_dim = launch.OB * B;
  reduce_splits<<<(out_dim + 255) / 256, 256, 0, launch.stream>>>(
      launch.partial, out_dim, launch.grid.y, launch.cum_tiles + launch.K,
      y);
  return (int)cudaGetLastError();
}

}  // namespace rank_prefix
