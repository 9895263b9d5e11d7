// Row-prefix effort matvec (bucket_size = 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel effort_tpu/kernels/fused_stream.py:_kernel_mxu
// (entry mxu_matvec, fused_stream.py:616-684). What it computes, for one
// instance e of a packed [E*nc+1, G, OBv] value tensor (e read from device
// memory, as the TPU kernel takes its `expert` by scalar prefetch, so a
// routed expert drives the kernel with no host round trip): the selection of
// row_prefix.cuh (u, the cutoff and the stream length C) at the 16.16
// fixed-point effort, then
//   y[j]    = sum over rows r < C*G of u_r * W_e[r, j], accumulated in f32
//
// Bound: bytes. The streamed prefix C*G*OBv*itemsize, v, stats, scales and
// probes once, y written once, over 3.35 TB/s; two operations a streamed
// weight. Three launches on the caller's stream, no host sync; the stream
// reads C from device memory, so moving the effort knob changes nothing on
// the host and a decode step stays capturable in a CUDA graph:
//   k1_select_kernel  min(nc, SMs) blocks of kSelThreads threads (the
//       wrapper's fused_stream.select_plan), each owning a run of whole
//       chunks: every block finds the cutoff itself
//       (row_prefix::find_cutoff: the same bits everywhere, no wait across
//       blocks), writes u for its rows and its chunks' f64 masses into a
//       per-card scratch with plain stores (a block's rows, up to
//       kRowRegs a thread, are loaded before the search and held in
//       registers; more go through row_prefix::chunk_masses after it);
//       the last block to finish (a
//       __threadfence and a ticket) scans the masses into C with one warp
//       (row_prefix::chunk_prefix_len) and sets the ticket back to 0. The
//       work that one block did alone (reading v, stats and scales, a
//       serial prefix on one thread) is spread over the card.
//   k1_stream_kernel  each warp streams its rows of the block's row range
//       (it ends at C*G) in 16-byte loads, the next rows' loads issued
//       before the current rows are decoded (int8 and int4 by a byte
//       permute and one add, exactly), so loads and arithmetic overlap;
//       partial sums of the block's columns go to device memory.
//   k1_reduce_kernel  adds the live splits in split order, so the output
//       is deterministic and greedy tokens repeat run to run.
// The stream and the split sum are launched as programmatic dependents
// (cudaLaunchAttributeProgrammaticStreamSerialization): each is scheduled
// while the launch before it runs and waits (griddepcontrol.wait) for its
// end before it reads C, u or the partial sums, so a launch's latency is
// hidden behind the work before it. The scratch and its ticket are one per
// card: calls on one CUDA stream run in order, and every launch of the
// port is on the caller's current stream, so no two selections use them
// at once.
//
// The instance. The kernels take base pointers of every instance and a
// pointer to the instance e (int32), and form their own offsets: values
// e*in_dim rows, probes e*P, stats and scales e*in_dim. The instance is
// written before the chain (by the routing's kernels, or it is a constant
// the wrapper keeps), and k1_select_kernel is an ordinary launch, which
// starts after all earlier work on the stream has ended; so the stream, a
// dependent, may read it before griddepcontrol.wait.

#include "row_prefix.cuh"

namespace {

using namespace row_prefix;

constexpr int kStreamThreads = 256;  // 8 warps; one warp row = 512 bytes
constexpr int kWarps = kStreamThreads / 32;
constexpr int kUnroll = 4;
constexpr int kRowRegs = 2;          // selection rows a thread holds

// programmatic dependent launch: let the next launch on the stream be
// scheduled, and wait until the launch before has ended and its writes are
// seen (a no-op for a launch that is no dependent)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// A selection block's rows [r0, r0 + n) (whole chunks of G rows, n <=
// kRowRegs * kSelThreads), row r0 + tid + q*kSelThreads in slot q: its
// selected mass x = stats * |v| and its u before selection, v * scale,
// loaded before the cutoff is known.
struct HeldRows {
  float x[kRowRegs], uv[kRowRegs];

  __device__ __forceinline__ void load(const float* __restrict__ v,
                                       const float* __restrict__ stats,
                                       const float* __restrict__ scales,
                                       int r0, int n) {
#pragma unroll
    for (int q = 0; q < kRowRegs; ++q) {
      const int r = r0 + threadIdx.x + q * kSelThreads;
      const bool in = r < r0 + n;
      const float vi = in ? v[r] : 0.f;
      x[q] = in ? __fmul_rn(stats[r], fabsf(vi)) : 0.f;
      uv[q] = (in && scales != nullptr) ? __fmul_rn(vi, scales[r]) : vi;
    }
  }

  // u of the rows, and each chunk's selected mass added (f64, exact in
  // any order) into s_mass[chunk - r0 / G], zeroed before: a warp's 32
  // rows lie in one chunk where G is a multiple of 32 (one add a warp),
  // else each row adds its own.
  __device__ __forceinline__ void select(float cutoff, int G, int r0, int n,
                                         __nv_bfloat16* __restrict__ u,
                                         double* s_mass) {
#pragma unroll
    for (int q = 0; q < kRowRegs; ++q) {
      const int r = threadIdx.x + q * kSelThreads;  // in the block's rows
      if (r - (int)(threadIdx.x & 31) >= n) break;  // the warp's rows
      const bool sel = r < n && x[q] > cutoff;
      if (r < n) u[r0 + r] = __float2bfloat16_rn(sel ? uv[q] : 0.f);
      double m = sel ? (double)x[q] : 0.0;
      if (G % 32 == 0) {
        m = warp_sum(m);
        if ((threadIdx.x & 31) == 0) atomicAdd(&s_mass[r / G], m);
      } else if (sel) {
        atomicAdd(&s_mass[r / G], m);
      }
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(kSelThreads) k1_select_kernel(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, const float* __restrict__ stats,
    const float* __restrict__ scales, const int32_t* __restrict__ eff_q,
    const int32_t* __restrict__ inst, const float* __restrict__ tables,
    int G, int nc, float tau, __nv_bfloat16* __restrict__ u,
    int32_t* __restrict__ c_out, float* __restrict__ cutoff_out,
    double* __restrict__ mass, unsigned int* __restrict__ ticket) {
  __shared__ double s_seg[kMaxSegs];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const float eff = __fmul_rn((float)eff_q[0], 1.0f / 65536.0f);
  const size_t e = (size_t)inst[0];
  probes += e * P;
  stats += e * nc * G;
  if (scales != nullptr) scales += e * nc * G;
  launch_dependents();
  const int c0 = (int)((long long)blockIdx.x * nc / gridDim.x);
  const int c1 = (int)((long long)(blockIdx.x + 1) * nc / gridDim.x);
  const int r0 = c0 * G, n = (c1 - c0) * G;
  // the block's rows, loaded while the cutoff is searched: into registers,
  // or into L2 (one 128-byte line a thread and array) past kRowRegs a
  // thread
  HeldRows rows;
  const bool held = n <= kRowRegs * kSelThreads;
  if (held) {
    rows.load(v, stats, scales, r0, n);
    if (tid < c1 - c0) s_seg[tid] = 0.0;  // before the search's barriers
  } else {
    for (int i = r0 + tid * 32; i < r0 + n; i += kSelThreads * 32) {
      prefetch_l2(v + i);
      prefetch_l2(stats + i);
      if (scales != nullptr) prefetch_l2(scales + i);
    }
  }
  const float cutoff = find_cutoff(v, P, stride, probes, eff, tables);
  if (held)
    rows.select(cutoff, G, r0, n, u, s_seg);
  else
    chunk_masses(v, stats, scales, cutoff, G, c0, c1 - c0, u, s_seg);
  // one thread stores the block's masses, makes them seen before its
  // ticket (u needs no fence: the stream waits for this grid's end) and
  // takes the ticket
  if (tid == 0) {
    for (int c = 0; c < c1 - c0; ++c) mass[c0 + c] = s_seg[c];
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || tid >= 32) return;
  __threadfence();
  // every block's masses, through L2
  for (int c = tid; c < nc; c += 32) s_seg[c] = __ldcg(mass + c);
  __syncwarp();
  const int C = chunk_prefix_len(s_seg, nc, tau);
  if (tid == 0) {
    c_out[0] = C;
    cutoff_out[0] = cutoff;
    *ticket = 0u;  // for the next call on this stream
  }
}

// grid (ceil(row_bytes / 512), ceil(in_dim / rows_per_block)). Block y
// owns rows [y*RB, min((y+1)*RB, C*G)) and writes partial[y][:] for its
// column tile; blocks past the streamed prefix exit at once.
template <int KIND>
__global__ void __launch_bounds__(kStreamThreads) k1_stream_kernel(
    const uint8_t* __restrict__ vals, const int32_t* __restrict__ inst,
    int in_dim, int row_bytes, int G, const int32_t* __restrict__ c_in,
    const __nv_bfloat16* __restrict__ u, int rows_per_block,
    float* __restrict__ partial, int width) {
  constexpr int N = Acc<KIND>::N;
  __shared__ float s_acc[kWarps][N][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * rows_per_block;
  const int cb = (blockIdx.x * 32 + lane) * 16;
  const bool active = cb < row_bytes;
  // written before the chain (see the top of the file): read before the
  // wait
  vals += (size_t)inst[0] * in_dim * row_bytes;
  wait_prior();
  launch_dependents();
  const int r_end = min(r0 + rows_per_block, c_in[0] * G);
  if (r0 >= r_end) return;

  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
  const uint16_t* ub = reinterpret_cast<const uint16_t*>(u);
  // rows r + q*kWarps of a step into (w, uu); zeros past r_end
  auto load = [&](int r, uint4* w, float* uu) {
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
  };
  if (active) {
    constexpr int kStep = kWarps * kUnroll;
    uint4 w[kUnroll], wn[kUnroll];
    float uu[kUnroll], un[kUnroll];
    load(r0 + warp, wn, un);
    for (int r = r0 + warp; r < r_end; r += kStep) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        w[q] = wn[q];
        uu[q] = un[q];
      }
      if (r + kStep < r_end) load(r + kStep, wn, un);
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
__global__ void k1_reduce_kernel(const float* __restrict__ partial,
                                 int width, int out_dim,
                                 const int32_t* __restrict__ c_in, int G,
                                 int rows_per_block, float* __restrict__ y) {
  wait_prior();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_dim) return;
  const int live = (c_in[0] * G + rows_per_block - 1) / rows_per_block;
  float s = 0.f;
  for (int sp = 0; sp < live; ++sp) s += partial[(size_t)sp * width + j];
  y[j] = s;
}

// kernel<<<grid, block, 0, stream>>>(args...) as a programmatic dependent
// of the launch before it on the stream
template <class... Params, class... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace

extern "C" {

// All pointers are device pointers of card `device`; `stream` is the
// caller's cudaStream_t on that card. probes, stats, scales and vals are
// those of instance 0; inst points to the instance, an int32 the kernels
// read (not range-checked). `blocks` selection blocks, 1 to nc
// (select_plan: at most one an SM). mass is the per-card scratch:
// kMaxChunks f64 and the ticket after them (zero between calls: the
// wrapper allocates it zeroed once a card). Returns the CUDA error of the
// launches (0 = none).
int effort_mxu_matvec(const float* v, const float* probes,
                      const float* stats, const float* scales,
                      const int32_t* eff_q, const int32_t* inst,
                      const float* tables, const void* vals, int kind,
                      int in_dim, int row_bytes,
                      int out_dim, int G, int nc, int P, int stride,
                      int blocks, float tau, int rows_per_block, int width,
                      void* u, int32_t* c_out, float* cutoff_out,
                      double* mass, float* partial, float* y, int device,
                      void* stream) {
  if (!select_fits(P, G, nc) || kind < 0 || kind > 2 ||
      row_bytes % 16 != 0 || blocks < 1 || blocks > nc)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* ub = static_cast<__nv_bfloat16*>(u);
  k1_select_kernel<<<blocks, kSelThreads, 0, st>>>(
      v, P, stride, probes, stats, scales, eff_q, inst, tables, G, nc, tau,
      ub, c_out, cutoff_out, mass,
      reinterpret_cast<unsigned int*>(mass + kMaxChunks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((row_bytes + 511) / 512,
                  (in_dim + rows_per_block - 1) / rows_per_block);
  const uint8_t* vb = static_cast<const uint8_t*>(vals);
  const __nv_bfloat16* uc = ub;
  const int32_t* cc = c_out;
  if (kind == kBf16)
    err = launch_dependent(k1_stream_kernel<kBf16>, grid,
                           dim3(kStreamThreads), st, vb, inst, in_dim,
                           row_bytes, G, cc, uc, rows_per_block, partial,
                           width);
  else if (kind == kInt8)
    err = launch_dependent(k1_stream_kernel<kInt8>, grid,
                           dim3(kStreamThreads), st, vb, inst, in_dim,
                           row_bytes, G, cc, uc, rows_per_block, partial,
                           width);
  else
    err = launch_dependent(k1_stream_kernel<kInt4>, grid,
                           dim3(kStreamThreads), st, vb, inst, in_dim,
                           row_bytes, G, cc, uc, rows_per_block, partial,
                           width);
  if (err != cudaSuccess) return (int)err;
  const float* pc = partial;
  err = launch_dependent(k1_reduce_kernel, dim3((out_dim + 255) / 256),
                         dim3(256), st, pc, width, out_dim, cc, G,
                         rows_per_block, y);
  return (int)err;
}

const char* effort_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
