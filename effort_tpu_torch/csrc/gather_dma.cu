// Block-gather effort matvec with packed positions (K6) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/gather_dma.py:_kernel (entry
// gather_matvec_dma, gather_dma.py:98-132): the exact-coverage gather of
// the (chunk, rank) blocks that ops/effort.select_blocks picked, bf16 or
// int8 values (int4 is refused, as there), positions packed 8/bits a byte.
// The body is block_gather.cuh's ring_gather_kernel: where the TPU kernel
// kept a ring of block DMAs in flight, one producer lane a block keeps a
// shared-memory ring of copy-engine (TMA) boxes in flight, one gathered
// block a stage, while four warps scatter the blocks that have landed.
//
// Bound: the gathered bytes of the real ids over 3.35 TB/s; the pad ids
// are not read.

#include "block_gather.cuh"

extern "C" {

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t there. vals and pos hold nrows = blocks * G rows
// of vrow and prow bytes; ids [n_ids] int32 (select_blocks' block_ids);
// n_blocks [1] int32, the real count before the capacity; u is [K, nc*G]
// f32; partial [splits, OB*B] f32 scratch; y [OB*B] f32. Returns the CUDA
// error (0 = none).
int effort_gather_matvec_dma(const void* vals, int kind, int vrow,
                             const void* pos, int prow, int nrows, int B,
                             const int32_t* ids, int n_ids,
                             const int32_t* n_blocks, const float* u, int K,
                             int nc, int G, int OB, float* partial,
                             int splits, int col_blocks, int threads,
                             float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  block_gather::GatherLaunch<rank_prefix::PackedPos> launch{
      static_cast<const uint8_t*>(vals), vrow,
      static_cast<const uint8_t*>(pos), prow, nrows, ids, n_ids, n_blocks, u,
      K, nc, G, OB, partial, dim3(col_blocks, splits), threads,
      static_cast<cudaStream_t>(stream), device, cudaSuccess};
  return block_gather::gather_matvec(kind, B, launch, y);
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
