// Rank-prefix effort matvec (K4, bucket_size >= 2) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:_kernel
// (entry fused_matvec, fused_stream.py:687-753): the selection in one
// block (rank_prefix::select_ranks: the cutoff at the 16.16 effort, rank
// counts n_i, u_k = v * [k < n_i] * scale in f32, each rank's coverage
// length C_k and its tile offsets), then the per-rank prefix stream and the
// split sum that K5 shares (rank_prefix.cuh). The TPU kernel takes its
// effort as a compile-time constant; this one reads it from the device at
// run time, as K1 does, so moving the knob needs no rebuild and no host
// sync.
//
// Bound: the streamed bytes (values + packed positions of the live tiles,
// v, stats and scales) over 3.35 TB/s. Left for later: the one-block
// selection (~20 us, as K1's) fused into the stream, and a TMA ring.

#include "rank_prefix.cuh"

namespace {

using namespace rank_prefix;

__global__ void __launch_bounds__(kSelThreads) fused_select_kernel(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, const int32_t* __restrict__ eff_q,
    const float* __restrict__ tables, int G, int nc, int K, int tgb,
    float tau, int expert, float* __restrict__ u,
    int32_t* __restrict__ c_out, int32_t* __restrict__ cum_tiles,
    int32_t* __restrict__ base_blocks, float* __restrict__ cutoff_out) {
  const float eff = __fmul_rn((float)eff_q[0], 1.0f / 65536.0f);
  select_ranks(v, P, stride, probes, stats, scales, eff, tables, G, nc, K,
               tgb, tau, expert, u, c_out, cum_tiles, base_blocks,
               cutoff_out);
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t there. v is the permuted input [nc*G] f32; probes
// [P], stats and scales (or null) [nc*G, K] of instance `expert`. Outputs:
// u [K, nc*G] f32, c_out [K], cum_tiles [K+1], base_blocks [K], cutoff
// [1], y [OB*B]; partial [splits, OB*B] f32 is scratch. Returns the CUDA
// error (0 = none).
int effort_fused_matvec(const float* v, const float* probes,
                        const float* stats, const float* scales,
                        const int32_t* eff_q, const float* tables,
                        const void* vals, int kind, int vrow, const void* pos,
                        int prow, int half, int B, int G, int nc, int K,
                        int tgb, int OB, int P, int stride, float tau,
                        int expert, float* u, int32_t* c_out,
                        int32_t* cum_tiles, int32_t* base_blocks,
                        float* cutoff, float* partial, int splits,
                        int col_blocks, int threads, float* y, int device,
                        void* stream) {
  if (P < 1 || P > row_prefix::kMaxP || K < 1 || K > kMaxRanks ||
      K * nc > kMaxMasses || device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[64];  // the shared-memory limit is raised once a card
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(fused_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxMasses * (int)sizeof(double));
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = true;
  }
  const int smem = K * nc * (int)sizeof(double);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_select_kernel<<<1, kSelThreads, smem, st>>>(
      v, P, stride, probes, stats, scales, eff_q, tables, G, nc, K, tgb, tau,
      expert, u, c_out, cum_tiles, base_blocks, cutoff);
  StreamLaunch launch{static_cast<const uint8_t*>(vals), vrow,
                      static_cast<const uint8_t*>(pos), prow, half,
                      cum_tiles, base_blocks, u, K, G, tgb, nc * G, OB,
                      partial, dim3(col_blocks, splits), threads, st};
  return stream_matvec(kind, B, launch, y);
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
