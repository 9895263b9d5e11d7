// The block-gather body shared by gather_dma.cu (K6, packed positions) and
// gather_mul.cu (K7, one position byte a column), for Hopper, sm_90a. The
// position decode is the template parameter Pos (rank_prefix.cuh).
//
// What it computes (effort_tpu/kernels/gather_dma.py:_kernel and
// gather_mul.py:_kernel): for each of the n_ids selected block ids (ops/
// effort.select_blocks: ascending, padded with the all-zero block), the
// block's G rows [G, OB] times u[k, g, :] with k = (id // nc) % K and
// g = id % nc, scattered by position into y[j*B + p]. Pads read the zero
// block and add nothing.
//
// grid (column blocks, S): split y takes ids y, y + S, ... (a block's four
// warps every fourth row of each) and writes its partial sums;
// rank_prefix::reduce_splits adds the S splits in order.
// Bound: the gathered bytes, n_ids * G * (value + position row bytes),
// over the card's memory rate.

#pragma once

#include "rank_prefix.cuh"

namespace block_gather {

using rank_prefix::kAccs;
using rank_prefix::Owned;

template <int KIND, int B, class Pos>
__global__ void __launch_bounds__(rank_prefix::kThreads) gather_kernel(
    const uint8_t* __restrict__ vals, int vrow,
    const uint8_t* __restrict__ pos, int prow,
    const int32_t* __restrict__ ids, int n_ids,
    const float* __restrict__ u, int K, int nc, int G, int OB,
    float* __restrict__ partial) {
  __shared__ float s_u[rank_prefix::kMaxTileRows];
  const int jb0 = (blockIdx.x * 32 + (threadIdx.x & 31)) *
                  Owned<B, Pos>::kNBT;
  const bool active = jb0 < prow;
  const int in_dim = nc * G;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  for (int b = blockIdx.y; b < n_ids; b += gridDim.y) {
    const int id = ids[b];
    const int k = (id / nc) % K, g = id % nc;
    const float* ub = u + (size_t)k * in_dim + (size_t)g * G;
    __syncthreads();  // the previous block's u is read
    for (int i = threadIdx.x; i < G; i += rank_prefix::kThreads)
      s_u[i] = ub[i];
    __syncthreads();
    if (active)
      rank_prefix::accum_rows<KIND, B, Pos>(vals, vrow, pos, prow, 0,
                                            (size_t)id * G, threadIdx.x >> 5,
                                            G, s_u, jb0, OB, acc);
  }
  rank_prefix::write_partial<B, Pos>(acc, prow, OB,
                                     partial + (size_t)blockIdx.y * OB * B);
}

// The launches of one gathered matvec on `stream`: the gather, then the
// split sum. Returns the CUDA error (0 = none); false from dispatch (a
// kind or B without an instance) is cudaErrorInvalidValue.
template <template <int> class Pos>
struct Launch {
  const uint8_t* vals;
  int vrow;
  const uint8_t* pos;
  int prow;
  const int32_t* ids;
  int n_ids;
  const float* u;
  int K, nc, G, OB;
  float* partial;
  dim3 grid;
  int threads;
  cudaStream_t stream;

  template <int KIND, int B>
  void run() {
    gather_kernel<KIND, B, Pos<B>><<<grid, threads, 0, stream>>>(
        vals, vrow, pos, prow, ids, n_ids, u, K, nc, G, OB, partial);
  }
};

template <template <int> class Pos>
int gather_matvec(int kind, int B, Launch<Pos> launch, float* y) {
  if (launch.G > rank_prefix::kMaxTileRows || launch.K < 1 ||
      launch.n_ids < 1 || (int)launch.grid.y > launch.n_ids ||
      launch.threads != rank_prefix::kThreads)
    return (int)cudaErrorInvalidValue;
  if (!rank_prefix::dispatch<false>(kind, B, launch))
    return (int)cudaErrorInvalidValue;
  const int out_dim = launch.OB * B;
  rank_prefix::reduce_splits<<<(out_dim + 255) / 256, 256, 0,
                               launch.stream>>>(launch.partial, out_dim,
                                                launch.grid.y, nullptr, y);
  return (int)cudaGetLastError();
}

}  // namespace block_gather
