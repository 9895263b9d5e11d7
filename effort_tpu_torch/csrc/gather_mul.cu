// Block-gather effort matvec with unpacked positions (K7) for Hopper,
// sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/gather_mul.py:_kernel (entry
// gather_bucket_matvec -> _gather_call, gather_mul.py:36-105): K6's
// function, reading positions one int8 a column
// (BucketedMatrix.pos_unpacked()) instead of packed. The body is
// block_gather.cuh's ring_gather_kernel with the byte-per-column position
// decode; a lane's 16 position bytes make its slabs rows of 512 bytes and
// more, which the ring cuts into boxes of at most 256.
//
// Bound: the gathered bytes of the real ids (values and one position byte
// a column) over 3.35 TB/s.

#include "block_gather.cuh"

extern "C" {

// As effort_gather_matvec_dma, with pos [E*K*nc+1, G, prow] int8, one
// position a column (prow >= OB).
int effort_gather_bucket_matvec(const void* vals, int kind, int vrow,
                                const void* pos, int prow, int nrows, int B,
                                const int32_t* ids, int n_ids,
                                const int32_t* n_blocks, const float* u,
                                int K, int nc, int G, int OB, float* partial,
                                int splits, int col_blocks, int threads,
                                float* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  block_gather::GatherLaunch<rank_prefix::BytePos> launch{
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
