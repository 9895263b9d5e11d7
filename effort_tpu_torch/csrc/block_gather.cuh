// The block-gather body shared by gather_dma.cu (K6, packed positions) and
// gather_mul.cu (K7, one position byte a column), for Hopper, sm_90a. The
// position decode is the template parameter Pos (rank_prefix.cuh).
//
// What it computes (effort_tpu/kernels/gather_dma.py:_kernel and
// gather_mul.py:_kernel): for each selected block id (ops/effort.
// select_blocks: the real ids ascending, then pads of the all-zero block up
// to the capacity), the block's G rows [G, OB] times u[k, g, :] with k =
// (id // nc) % K and g = id % nc, scattered by position into y[j*B + p].
//
// Bound: the gathered bytes, n * G * (value + position row bytes) for the
// n real ids, over the card's memory rate. The TPU kernel keeps S block
// copies in flight in a ring of VMEM slots; ring_gather_kernel does the
// same with rank_prefix.cuh's ring: one producer lane asks the copy engine
// (TMA) for each id's G rows, value and position bytes as 2-D boxes of G
// rows at row id * G, into a stage of a shared-memory ring on the stage's
// mbarrier, and keeps every free stage in flight while four consumer
// warps scatter the stages that have landed (u for a stage's rows loaded a
// stage ahead). Two things are skipped, neither changing a bit: the pad ids
// (only min(n_blocks, n_ids) ids are walked, n_blocks read on the device),
// and rows whose u is 0 (a product of 0 and a finite weight is +-0, and a
// sum that starts at +0 is never -0, so adding it changes nothing).
//
// grid (column blocks, S): split y takes ids y, y + S, ... (warp w rows r =
// w mod 4 of each, in order) and writes its partial sums; splits with no
// real id exit at once, and rank_prefix::reduce_splits adds the first
// min(S, n_blocks) splits in order.

#pragma once

#include "rank_prefix.cuh"

namespace block_gather {

using rank_prefix::kAccs;
using rank_prefix::kMaxBoxes;
using rank_prefix::kMaxStages;
using rank_prefix::kRingThreads;
using rank_prefix::kRowWarps;
using rank_prefix::Ring;

constexpr int kMaxRows = 32;  // rows of a gathered block (G): a stage's box

template <int KIND, int B, class Pos>
__global__ void __launch_bounds__(kRingThreads, 3) ring_gather_kernel(
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap pmap, int prow,
    const int32_t* __restrict__ ids, int n_ids,
    const int32_t* __restrict__ n_blocks, const float* __restrict__ u,
    int K, int nc, int G, int OB, int stages, float* __restrict__ partial) {
  using namespace rank_prefix;
  using R = Ring<KIND, B, Pos>;
  constexpr int PB = R::kPB, NBT = R::kNBT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int s_box[kMaxBoxes][3];
  __shared__ int s_nbox;
  __shared__ uint32_t s_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrival with its bytes
      mbar_init(&empty[s], kRowWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_nbox = stage_boxes<KIND, B, Pos>(blockIdx.x, prow, 0, OB, G, s_box,
                                       &s_bytes);
  }
  __syncthreads();
  // the real ids come first; the capacity may cut n_blocks
  const int n_real = min(n_blocks[0], n_ids);
  if ((int)blockIdx.y >= n_real || s_nbox == 0) return;
  const int units = (n_real - 1 - (int)blockIdx.y) / (int)gridDim.y + 1;
  const int stage_bytes = R::stage_bytes(G);

  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  if (warp == kRowWarps) {
    // producer: id n of the split goes into slot n % stages once the
    // consumers have released its previous use
    if (lane == 0) {
      const int nbox = s_nbox;
      const uint32_t bytes = s_bytes;
      for (int n = 0; n < units; ++n) {
        const int slot = n % stages;
        const uint32_t use = n / stages;
        const int row0 = ids[blockIdx.y + n * gridDim.y] * G;
        if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
        uint8_t* st = ring + slot * stage_bytes;
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
      live[t] = active && t * prow + jb0 < OB;
      hi[t] = false;
    }
    // u of the warp's rows q = warp + 4m of id n: lane m holds row m's,
    // loaded a stage ahead
    auto u_of = [&](int n) {
      const int q = warp + kRowWarps * lane;
      if (n >= units || lane >= kMaxRows / kRowWarps || q >= G) return 0.f;
      const int id = ids[blockIdx.y + n * gridDim.y];
      return u[((size_t)((id / nc) % K) * nc + id % nc) * G + q];
    };
    float u_next = u_of(0);
    for (int n = 0; n < units; ++n) {
      const int slot = n % stages;
      const float um = u_next;
      u_next = u_of(n + 1);
      mbar_wait(&full[slot], (n / stages) & 1);
      const uint8_t* st = ring + slot * stage_bytes;
#pragma unroll 2  // two rows' loads in flight
      for (int m = 0; m < kMaxRows / kRowWarps; ++m) {
        const int q = warp + kRowWarps * m;
        if (q >= G) break;
        const float uu = __shfl_sync(0xffffffffu, um, m);
        if (!active || uu == 0.f) continue;
        scatter_row<KIND, B, Pos>(st, G, q, lane, uu, live, hi, acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }
  write_sums<B, Pos>(acc, ring, prow, OB,
                     partial + (size_t)blockIdx.y * OB * B);
}

// Per library: the dynamic shared bytes ring_gather_kernel<KIND, B, Pos>
// may take, as raised so far, by kind, log2(B) and card.
static int gather_smem_set[3][6][64];

// The launches of one gathered matvec on `stream`: the gather over grid
// (column blocks, splits), then the split sum of the splits that held a
// real id. vals and pos hold nrows = blocks * G rows of vrow and prow
// bytes; n_blocks is the selection's real count (device). Returns the
// CUDA error (0 = none).
template <template <int> class Pos>
struct GatherLaunch {
  const uint8_t* vals;
  int vrow;
  const uint8_t* pos;
  int prow, nrows;
  const int32_t* ids;
  int n_ids;
  const int32_t* n_blocks;
  const float* u;
  int K, nc, G, OB;
  float* partial;
  dim3 grid;
  int threads;
  cudaStream_t stream;
  int device;
  cudaError_t error;  // of the tensor maps or the shared-memory limit

  template <int KIND, int B>
  void run() {
    using R = Ring<KIND, B, Pos<B>>;
    CUtensorMap vmap, pmap;
    error = rank_prefix::encode_rows(&vmap, vals, vrow, nrows, R::kVPart, G);
    if (error == cudaSuccess)
      error = rank_prefix::encode_rows(&pmap, pos, prow, nrows, R::kPPart, G);
    if (error != cudaSuccess) return;
    const int smem = R::smem(G);
    int& set = gather_smem_set[KIND][rank_prefix::log2_of(B)][device];
    if (set < smem) {  // the shared-memory limit, raised as calls need
      error = cudaFuncSetAttribute(ring_gather_kernel<KIND, B, Pos<B>>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
      if (error != cudaSuccess) return;
      set = smem;
    }
    ring_gather_kernel<KIND, B, Pos<B>><<<grid, threads, smem, stream>>>(
        vmap, pmap, prow, ids, n_ids, n_blocks, u, K, nc, G, OB,
        R::stages(G), partial);
  }
};

template <template <int> class Pos>
int gather_matvec(int kind, int B, GatherLaunch<Pos>& launch, float* y) {
  // the copy engine needs 16-byte aligned rows; at most one split an id
  if (launch.G < 1 || launch.G > kMaxRows || launch.K < 1 ||
      launch.nc < 1 || launch.n_ids < 1 ||
      (int)launch.grid.y > launch.n_ids || launch.threads != kRingThreads ||
      launch.device < 0 || launch.device >= 64 ||
      (launch.vrow | launch.prow) % 16 ||
      (reinterpret_cast<uintptr_t>(launch.vals) |
       reinterpret_cast<uintptr_t>(launch.pos)) % 16)
    return (int)cudaErrorInvalidValue;
  launch.error = cudaSuccess;
  if (!rank_prefix::dispatch<false>(kind, B, launch))
    return (int)cudaErrorInvalidValue;
  if (launch.error != cudaSuccess) return (int)launch.error;
  const int out_dim = launch.OB * B;
  rank_prefix::reduce_splits<<<(out_dim + 255) / 256, 256, 0,
                               launch.stream>>>(launch.partial, out_dim,
                                                launch.grid.y,
                                                launch.n_blocks, y);
  return (int)cudaGetLastError();
}

}  // namespace block_gather
