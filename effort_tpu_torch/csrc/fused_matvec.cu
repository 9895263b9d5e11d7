// Rank-prefix effort matvec (K4, bucket_size >= 2) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:_kernel (:145;
// entry fused_matvec, :687-753): the selection (the cutoff at the 16.16
// effort, rank counts n_i, u_k = v * [k < n_i] * scale in f32, each rank's
// coverage length C_k and its tile offsets), then the per-rank prefix
// stream and the split sum that K5 shares (rank_prefix.cuh). The TPU kernel
// takes its effort as a compile-time constant; this one reads it from the
// device at run time, as K1 does, so moving the knob needs no rebuild and
// no host sync. The instance e (the TPU kernel's scalar-prefetched
// `expert`) is read from device memory too: grid_select_kernel takes the
// probes, stats and scales of instance 0 and a pointer to e, offsets them
// itself (probes e*P, stats and scales e*in_dim*K) and writes the rank
// slabs' first blocks, base_blocks[k] = (e*K + k)*nc, which the stream
// reads; the stream's copy-engine maps span every instance. So a routed
// expert drives K4 with no host round trip.
//
// Bound: bytes. A call must move the values and packed positions of the
// live tiles, v, stats and scales once, and writes y; it does two
// operations a streamed weight, far below the card's rate. Three launches,
// in stream order:
//   grid_select_kernel  min(nc, SMs) blocks of 1024 threads, each owning a
//       run of whole chunks: every block finds the cutoff itself (the same
//       bits everywhere, no wait across blocks), then writes u for its rows
//       and its chunks' f64 masses into a per-card scratch with plain
//       stores; the last block to finish (a __threadfence and a ticket)
//       loads all the masses into its shared memory at once, scans them
//       into C_k and the tile offsets, and sets the ticket back to 0. So
//       reading v, stats and scales is spread over the card instead of
//       one SM; the cutoff search, which every block repeats, sets the
//       kernel's time.
//   ring_stream_kernel  the stream: one producer lane keeps every free
//       stage of a shared-memory ring in flight, each stage a few 2-D
//       copy-engine boxes (TMA: 32 rows of the block's value and position
//       bytes) on an mbarrier, while four warps compute on the stages that
//       have landed, so a block's bytes are in flight at once instead of a
//       few rows a warp.
//   reduce_splits       the live splits' partial sums, in split order.
// The scratch and its ticket are one per card: calls on one CUDA stream
// run in order, and every launch of the port is on the caller's current
// stream, so no two selections use them at once.

#include "rank_prefix.cuh"

namespace {

using namespace rank_prefix;

__global__ void __launch_bounds__(kSelThreads) grid_select_kernel(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, const int32_t* __restrict__ eff_q,
    const float* __restrict__ tables, int G, int nc, int K, int tgb,
    float tau, const int32_t* __restrict__ inst, float* __restrict__ u,
    int32_t* __restrict__ c_out, int32_t* __restrict__ cum_tiles,
    int32_t* __restrict__ base_blocks, float* __restrict__ cutoff_out,
    double* __restrict__ mass, unsigned int* __restrict__ ticket) {
  extern __shared__ double s_mass[];  // [K][nc] (this block's: [K][nch])
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const float eff = __fmul_rn((float)eff_q[0], 1.0f / 65536.0f);
  const int expert = inst[0];
  probes += (size_t)expert * P;
  stats += (size_t)expert * nc * G * K;
  if (scales != nullptr) scales += (size_t)expert * nc * G * K;
  const float cutoff = row_prefix::find_cutoff(v, P, stride, probes, eff,
                                               tables);
  const int c0 = (int)((long long)blockIdx.x * nc / gridDim.x);
  const int c1 = (int)((long long)(blockIdx.x + 1) * nc / gridDim.x);
  const int nch = c1 - c0;
  for (int i = tid; i < K * nch; i += kSelThreads) s_mass[i] = 0.0;
  __syncthreads();
  if (G % 4 == 0)
    rank_rows<4>(v, stats, scales, cutoff, G, c0 * G, nch * G, nc * G, K, u,
                 s_mass);
  else
    rank_rows<1>(v, stats, scales, cutoff, G, c0 * G, nch * G, nc * G, K, u,
                 s_mass);
  __syncthreads();
  for (int i = tid; i < K * nch; i += kSelThreads)
    mass[(size_t)(i / nch) * nc + c0 + i % nch] = s_mass[i];
  __threadfence();  // the masses are seen before the ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every block's masses, through L2, into shared memory at once
  for (int i = tid; i < K * nc; i += kSelThreads) s_mass[i] = __ldcg(mass + i);
  __syncthreads();
  rank_scan(s_mass, nc, K, tgb, tau, expert, cutoff, c_out, cum_tiles,
            base_blocks, cutoff_out);
  if (tid == 0) *ticket = 0u;  // for the next call on this stream
}

int sm_count(int device) {
  static int sms[64];
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return sms[device];
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t there. vals and pos hold nrows rows of vrow and
// prow bytes (half: int4's low-nibble columns). v is the permuted input
// [nc*G] f32; probes [P], stats and scales (or null) [nc*G, K] are those
// of instance 0, and inst points to the instance, an int32 the selection
// reads (not range-checked). Outputs:
// u [K, nc*G] f32, c_out [K], cum_tiles [K+1], base_blocks [K], cutoff
// [1], y [OB*B]; partial [splits, OB*B] f32 is scratch, and so are mass
// [kMaxMasses] f64 and the ticket after it (zero between calls: the
// wrapper allocates them zeroed once a card). Returns the CUDA error (0 =
// none).
int effort_fused_matvec(const float* v, const float* probes,
                        const float* stats, const float* scales,
                        const int32_t* eff_q, const float* tables,
                        const void* vals, int kind, int vrow, const void* pos,
                        int prow, int half, int nrows, int B, int G, int nc,
                        int K, int tgb, int OB, int P, int stride, float tau,
                        const int32_t* inst, float* u, int32_t* c_out,
                        int32_t* cum_tiles, int32_t* base_blocks,
                        float* cutoff, double* mass, float* partial,
                        int splits, int col_blocks, int threads, float* y,
                        int device, void* stream) {
  if (P < 1 || P > row_prefix::kMaxP || K < 1 || K > kMaxRanks ||
      K * nc > kMaxMasses || nc < 1 || device < 0 || device >= 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  static bool smem_set[64];  // the shared-memory limit is raised once a card
  if (!smem_set[device]) {
    err = cudaFuncSetAttribute(grid_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxMasses * (int)sizeof(double));
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = true;
  }
  const int blocks = nc < sms ? nc : sms;
  const int smem = K * nc * (int)sizeof(double);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  grid_select_kernel<<<blocks, kSelThreads, smem, st>>>(
      v, P, stride, probes, stats, scales, eff_q, tables, G, nc, K, tgb, tau,
      inst, u, c_out, cum_tiles, base_blocks, cutoff, mass,
      reinterpret_cast<unsigned int*>(mass + kMaxMasses));
  StreamLaunch launch{static_cast<const uint8_t*>(vals), vrow,
                      static_cast<const uint8_t*>(pos), prow, half, nrows,
                      cum_tiles, base_blocks, u, K, G, tgb, nc * G, OB,
                      partial, dim3(col_blocks, splits), threads, st,
                      device, cudaSuccess};
  return stream_matvec(kind, B, launch, y);
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
