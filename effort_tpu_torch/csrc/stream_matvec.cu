// Rank-prefix stream (K5) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/prefix_stream.py:_kernel
// (entry stream_matvec, prefix_stream.py:176-210): given a selection from
// select_stream (cum_tiles [K+1], base_blocks [K], u [K, nc, G] f32, all on
// the device), stream the first cum_tiles[k+1] - cum_tiles[k] tiles of TGB
// chunks of every rank slab and scatter by position into y[j*B + p]. The
// body is rank_prefix.cuh's, shared with K4. The tile count stays on the
// device: the grid is sized for all K*nc/TGB tiles and splits past the
// last live tile exit at once, so there is no host sync.
//
// Bound: the streamed bytes (values + packed positions of the live tiles,
// and u) over 3.35 TB/s. The body is rank_prefix.cuh's ring stream, the
// one K4 runs: one producer lane keeps the stages of a shared-memory ring
// in flight as 2-D copy-engine boxes (TMA) on an mbarrier a stage, while
// four warps compute. Left for later: skipping rows whose u is 0 inside a
// tile.

#include "rank_prefix.cuh"

extern "C" {

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t there. vals and pos hold nrows rows of vrow and
// prow bytes. partial is [splits, OB*B] f32 scratch; y
// [OB*B] f32. Returns the CUDA error (0 = none).
int effort_stream_matvec(const void* vals, int kind, int vrow,
                         const void* pos, int prow, int half, int nrows,
                         int B,
                         const int32_t* cum_tiles,
                         const int32_t* base_blocks, const float* u, int K,
                         int G, int tgb, int in_dim, int OB, float* partial,
                         int splits, int col_blocks, int threads, float* y,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rank_prefix::StreamLaunch launch{
      static_cast<const uint8_t*>(vals), vrow,
      static_cast<const uint8_t*>(pos), prow, half, nrows, cum_tiles,
      base_blocks, u, K, G, tgb, in_dim, OB, partial,
      dim3(col_blocks, splits), threads, static_cast<cudaStream_t>(stream),
      device, cudaSuccess};
  return rank_prefix::stream_matvec(kind, B, launch, y);
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
