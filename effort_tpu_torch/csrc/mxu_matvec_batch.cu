// Batched row-prefix effort matmul (bucket_size = 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:
// _kernel_mxu_batch (entry mxu_matvec_batch, fused_stream.py:506-571).
// T slots (prefill tokens, or the decode slots of a batch) share one
// instance e of a packed [E*nc+1, G, OBv] value tensor:
//
//   per slot t: the selection of row_prefix.cuh at the slot's own f32
//               effort -> u_t [in] bf16 and the slot's stream length C_t
//   C        = max over slots of C_t (fused_stream.py:437)
//   Y[t, j]  = sum over rows r < C*G of u_t[r] * W_e[r, j], f32
//
// Three launches on the caller's stream, no host sync:
//   1. select_batch_kernel, one block per slot, writes u [T, in], C_t;
//   2. stream_batch_kernel reads C = max C_t on the device and streams the
//      first C*G rows. Grid (slot tiles, column tiles, row splits): a
//      thread owns 16 bytes of a row (8/16/32 columns) for a tile of TS
//      slots, so each weight row it loads serves TS slots; the slot tiles
//      of one (column, rows) tile are neighbours in launch order and find
//      the rows in L2. u of the tile's slots is staged in shared memory
//      as f32, 128 rows at a time. Each block writes its partial sums to
//      partial[split][slot][col];
//   3. reduce_batch_kernel adds the live splits in split order (no float
//      atomics: deterministic) and writes C.
//
// Bound: the streamed bytes C*G*row_bytes (plus u's inputs and Y) over
// 3.35 TB/s while T is small; at T = 64 the 2*T*C*G*OB flops on CUDA cores
// (67 TFLOP/s f32) exceed it. This is the simple SIMT version; a tensor-
// core (mma.sync/wgmma) stream with a TMA ring is the later step.

#include "row_prefix.cuh"

namespace {

using namespace row_prefix;

constexpr int kThreads = 128;     // 4 warps; a warp covers 512 bytes of a row
constexpr int kColBytes = kThreads * 16;
constexpr int kUnroll = 4;
constexpr int kStageRows = 128;   // rows of u staged in shared memory

// Slots per tile: 64 accumulators a thread (TS * columns per 16 bytes).
template <int KIND>
struct Tile {
  static constexpr int TS = 64 / Acc<KIND>::N;
};

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

__device__ __forceinline__ int max_len(const int32_t* __restrict__ c_slot,
                                       int T) {
  int c = 1;
  for (int t = 0; t < T; ++t) c = max(c, c_slot[t]);
  return c;
}

// Block (x, y, z) covers slots [x*TS, x*TS+TS), row bytes
// [y*kColBytes, (y+1)*kColBytes) and rows [z*RB, min((z+1)*RB, C*G));
// blocks past the streamed prefix exit at once.
template <int KIND>
__global__ void __launch_bounds__(kThreads) stream_batch_kernel(
    const uint8_t* __restrict__ vals, int row_bytes, int G,
    const int32_t* __restrict__ c_slot, int T,
    const __nv_bfloat16* __restrict__ u, int in_dim, int rows_per_block,
    float* __restrict__ partial, int width) {
  constexpr int N = Acc<KIND>::N;
  constexpr int TS = Tile<KIND>::TS;
  __shared__ float s_u[kStageRows][TS];
  const int r0 = blockIdx.z * rows_per_block;
  const int r_end = min(r0 + rows_per_block, max_len(c_slot, T) * G);
  if (r0 >= r_end) return;  // the same for every thread of the block
  const int t0 = blockIdx.x * TS;
  const int cb = blockIdx.y * kColBytes + threadIdx.x * 16;
  const bool active = cb < row_bytes;
  const uint16_t* ub = reinterpret_cast<const uint16_t*>(u);

  float acc[TS][N];
#pragma unroll
  for (int s = 0; s < TS; ++s)
#pragma unroll
    for (int k = 0; k < N; ++k) acc[s][k] = 0.f;

  for (int rs = r0; rs < r_end; rs += kStageRows) {
    const int n = min(kStageRows, r_end - rs);
    __syncthreads();  // the previous stage is read
    for (int i = threadIdx.x; i < kStageRows * TS; i += kThreads) {
      const int s = i / kStageRows, rr = i % kStageRows;
      const int t = t0 + s;
      s_u[rr][s] = (rr < n && t < T)
          ? __uint_as_float((uint32_t)ub[(size_t)t * in_dim + rs + rr] << 16)
          : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < n; r += kUnroll) {
      uint4 w[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        w[q] = r + q < n ? __ldg(reinterpret_cast<const uint4*>(
                               vals + (size_t)(rs + r + q) * row_bytes + cb))
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        float x[N];
        decode16<KIND>(w[q], x);
        // r + q < kStageRows; rows past n stage u = 0 and load w = 0
        const float* us = s_u[r + q];
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          const float uu = us[s];
#pragma unroll
          for (int k = 0; k < N; ++k) acc[s][k] = fmaf(uu, x[k], acc[s][k]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int s = 0; s < TS; ++s) {
    if (t0 + s >= T) break;
    float* out = partial + ((size_t)blockIdx.z * T + t0 + s) * width;
#pragma unroll
    for (int k = 0; k < N; ++k) out[acc_col<KIND>(cb, k, row_bytes)] = acc[s][k];
  }
}

// Y[t, j] = sum over the live splits sp < ceil(C*G / RB) of
// partial[sp][t][j], in split order; block (0, 0) writes C.
__global__ void reduce_batch_kernel(const float* __restrict__ partial,
                                    int width, int out_dim, int T,
                                    const int32_t* __restrict__ c_slot, int G,
                                    int rows_per_block, float* __restrict__ y,
                                    int32_t* __restrict__ c_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  const int C = max_len(c_slot, T);
  if (j == 0 && t == 0) c_out[0] = C;
  if (j >= out_dim) return;
  const int live = (C * G + rows_per_block - 1) / rows_per_block;
  float s = 0.f;
  for (int sp = 0; sp < live; ++sp)
    s += partial[((size_t)sp * T + t) * width + j];
  y[(size_t)t * out_dim + j] = s;
}

template <int KIND>
void launch_stream(const uint8_t* vals, int row_bytes, int G,
                   const int32_t* c_slot, int T, const __nv_bfloat16* u,
                   int in_dim, int rows_per_block, float* partial, int width,
                   cudaStream_t st) {
  constexpr int TS = Tile<KIND>::TS;
  const dim3 grid((T + TS - 1) / TS, (row_bytes + kColBytes - 1) / kColBytes,
                  (in_dim + rows_per_block - 1) / rows_per_block);
  stream_batch_kernel<KIND><<<grid, kThreads, 0, st>>>(
      vals, row_bytes, G, c_slot, T, u, in_dim, rows_per_block, partial,
      width);
}

}  // namespace

extern "C" {

// Slots per tile of the streaming kernel for value kind `kind` (sizes the
// wrapper's grid arithmetic).
int effort_mxu_batch_slot_tile(int kind) {
  return kind == kBf16 ? Tile<kBf16>::TS
                       : (kind == kInt8 ? Tile<kInt8>::TS : Tile<kInt4>::TS);
}

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t on that card. V [T, in_dim] f32 (permuted rows),
// efforts [T] f32, u [T, in_dim] bf16, c_slot/cutoff [T], c_out [1],
// partial [ceil(in_dim/RB), T, width] f32, y [T, out_dim] f32. Returns
// the CUDA error of the launches (0 = none).
int effort_mxu_matvec_batch(const float* V, int T, const float* probes,
                            const float* stats, const float* scales,
                            const float* efforts, const float* tables,
                            const void* vals, int kind, int in_dim,
                            int row_bytes, int out_dim, int G, int nc, int P,
                            int stride, float tau, int rows_per_block,
                            int width, void* u, int32_t* c_slot,
                            float* cutoff, int32_t* c_out, float* partial,
                            float* y, int device, void* stream) {
  if (!select_fits(P, G, nc) || kind < 0 || kind > 2 || T < 1 ||
      T > 65535 || row_bytes % 16 != 0 || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* ub = static_cast<__nv_bfloat16*>(u);
  select_batch_kernel<<<T, kSelThreads, 0, st>>>(
      V, in_dim, P, stride, probes, stats, scales, efforts, tables, G, nc,
      tau, ub, c_slot, cutoff);
  const uint8_t* vb = static_cast<const uint8_t*>(vals);
  if (kind == kBf16)
    launch_stream<kBf16>(vb, row_bytes, G, c_slot, T, ub, in_dim,
                         rows_per_block, partial, width, st);
  else if (kind == kInt8)
    launch_stream<kInt8>(vb, row_bytes, G, c_slot, T, ub, in_dim,
                         rows_per_block, partial, width, st);
  else
    launch_stream<kInt4>(vb, row_bytes, G, c_slot, T, ub, in_dim,
                         rows_per_block, partial, width, st);
  reduce_batch_kernel<<<dim3((out_dim + 255) / 256, T), 256, 0, st>>>(
      partial, width, out_dim, T, c_slot, G, rows_per_block, y, c_out);
  return (int)cudaGetLastError();
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
