// Row-prefix effort matvec (bucket_size = 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:_kernel_mxu
// (entry mxu_matvec, fused_stream.py:616-684). What it computes, for one
// instance e of a packed [E*nc+1, G, OBv] value tensor: the selection of
// row_prefix.cuh (u, the cutoff and the stream length C) at the 16.16
// fixed-point effort, then
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

#include "row_prefix.cuh"

namespace {

using namespace row_prefix;

constexpr int kStreamThreads = 256;  // 8 warps; one warp row = 512 bytes
constexpr int kWarps = kStreamThreads / 32;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kSelThreads) select_kernel(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, const int32_t* __restrict__ eff_q,
    const float* __restrict__ tables, int G, int nc, float tau,
    __nv_bfloat16* __restrict__ u, int32_t* __restrict__ c_out,
    float* __restrict__ cutoff_out) {
  const float eff = __fmul_rn((float)eff_q[0], 1.0f / 65536.0f);
  select_rows(v, P, stride, probes, stats, scales, eff, tables, G, nc, tau,
              u, c_out, cutoff_out);
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
  if (!select_fits(P, G, nc) || kind < 0 || kind > 2 ||
      row_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* ub = static_cast<__nv_bfloat16*>(u);
  select_kernel<<<1, kSelThreads, 0, st>>>(v, P, stride, probes, stats,
                                           scales, eff_q, tables, G, nc, tau,
                                           ub, c_out, cutoff_out);
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
