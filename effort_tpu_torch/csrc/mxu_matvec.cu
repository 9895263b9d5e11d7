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
//   k1_select_kernel  kSelThreads threads a block: one block where it
//       holds every row in registers (in_dim <= kRowRegs * kSelThreads),
//       else min(nc, SMs) blocks, each owning a run of whole chunks (the
//       wrapper's fused_stream.select_plan). Every block finds the cutoff
//       itself (k1_find_cutoff, row_prefix::find_cutoff's search with its
//       counts in kCopies histograms: the same bits everywhere, no wait
//       across blocks) and writes u for its rows and its chunks' f64
//       masses (a block's rows, up to kRowRegs a thread, are loaded before
//       the search and held in registers; more go through
//       row_prefix::chunk_masses after it). One block scans its masses
//       into C with one warp (row_prefix::chunk_prefix_len); of several,
//       each stores its masses into a per-card scratch, and the last to
//       finish (a __threadfence and a ticket) scans them and sets the
//       ticket back to 0.
//   k1_stream_kernel  each warp streams its rows of the block's row range
//       (it ends at C*G) in 16-byte loads, the next rows' loads issued
//       before the current rows are decoded (int8 and int4 by a byte
//       permute and one add, exactly), so loads and arithmetic overlap;
//       partial sums of the block's columns go to device memory.
//   k1_reduce_kernel  adds the live splits in split order, so the output
//       is deterministic and greedy tokens repeat run to run.
// All three are launched as programmatic dependents
// (cudaLaunchAttributeProgrammaticStreamSerialization): each is scheduled
// while the launch before it runs and waits (griddepcontrol.wait) for its
// end before it reads its inputs, so a launch's latency is hidden behind
// the work before it. HBM would idle through the selection, which sets a
// call's time on every matrix of the cells (a few us against a stream of
// 0.3-9 us); so the stream's blocks, resident beside the selection, ask
// their rows among the leading kPrefetchNum / kPrefetchDen of the chunks
// (rows every C streams first, at most kPrefetchBytes) into L2 before they
// wait, and read them from there once C is known. The scratch and its
// ticket are one per card: calls on one CUDA stream run in order, and
// every launch of the port is on the caller's current stream, so no two
// selections use them at once.
//
// The instance. The kernels take base pointers of every instance and a
// pointer to the instance e (int32), and form their own offsets: values
// e*in_dim rows, probes e*P, stats and scales e*in_dim. The instance is
// written before the chain (by the routing's kernels, or it is a constant
// the wrapper keeps); k1_select_kernel reads it after its wait and lets
// the stream be scheduled only then, so the stream, a dependent, may read
// it before its own griddepcontrol.wait.

#include "row_prefix.cuh"

namespace {

using namespace row_prefix;

constexpr int kStreamThreads = 256;  // 8 warps; one warp row = 512 bytes
constexpr int kWarps = kStreamThreads / 32;
constexpr int kUnroll = 4;
constexpr int kRowRegs = 2;          // selection rows a thread holds
constexpr int kCopies = 4;           // histograms of a cutoff search level
// The leading rows the stream prefetches into L2 while the selection runs:
// the first kPrefetchNum / kPrefetchDen of the chunks, and at most
// kPrefetchBytes of values (about what HBM moves in a selection's time).
constexpr int kPrefetchNum = 1, kPrefetchDen = 4;
constexpr long long kPrefetchBytes = 24ll << 20;

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

// One level of the cutoff search, as row_prefix::level_misses counts it,
// with the counts in kCopies histograms (warp w adds into copy w %
// kCopies; hist holds kCopies * kNL, zeroed by the caller): after the
// barrier a lane adds kCopies counts. level_misses has every warp add all
// 32 warps' histograms, 32 times the shared-memory reads, which its
// bandwidth makes about a thousand cycles a level. Integer counts: the
// same answer.
template <class Thr, class Est>
__device__ __forceinline__ int k1_level_misses(const float* sc, int* hist,
                                               int kq, Thr t, Est est) {
  const int lane = threadIdx.x & 31;
  int* own = hist + ((threadIdx.x >> 5) % kCopies) * kNL;
#pragma unroll
  for (int k = 0; k < kScores; ++k) {
    if (!(sc[k] >= 0.f)) continue;
    const int b = bin_from(sc[k], est(sc[k]), t);
    if (b < kNL) atomicAdd(&own[b], 1);
  }
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int q = 0; q < kCopies; ++q) c += hist[q * kNL + lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += y;
  }
  return __popc(__ballot_sync(0xffffffffu, c < kq));
}

// row_prefix::find_cutoff, bit for bit, with its levels counted by
// k1_level_misses (K2 and K4 keep find_cutoff).
__device__ __forceinline__ float k1_find_cutoff(
    const float* __restrict__ v, int P, int stride,
    const float* __restrict__ probes, float eff,
    const float* __restrict__ tables) {
  __shared__ float s_wmax[kSelWarps];
  __shared__ float s_tab[2 * kNL];
  __shared__ int s_hist[2][kCopies * kNL];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 2 * kNL) s_tab[tid] = tables[tid];
  if (tid < kCopies * kNL) {
    s_hist[0][tid] = 0;
    s_hist[1][tid] = 0;
  }
  float sc[kScores];
  float mx = 0.f;  // scores are >= 0; -1 marks past P
#pragma unroll
  for (int k = 0; k < kScores; ++k) {
    const int i = tid + k * kSelThreads;
    sc[k] = i < P ? fabsf(__fmul_rn(v[(size_t)i * stride], probes[i])) : -1.f;
    mx = fmaxf(mx, sc[k]);
  }
  mx = warp_max(mx);
  if (lane == 0) s_wmax[tid >> 5] = mx;
  __syncthreads();
  const float m = __fadd_rn(warp_max(s_wmax[lane]), 1e-30f);
  const int kq = (int)fminf(fmaxf(rintf(__fmul_rn((float)P, eff)), 1.f),
                            (float)P);
  const float log2m = __log2f(m);
  const int nh = k1_level_misses(
      sc, s_hist[0], kq, [&](int j) { return __fmul_rn(m, s_tab[j]); },
      [&](float x) {
        return clamp_bin((__log2f(x) - log2m) * -1.4499901f);  // 1/log2 .62
      });
  const float lo = nh < kNL ? __fmul_rn(m, s_tab[nh]) : 0.f;
  const float hi = (nh < kNL && nh >= 1) ? __fmul_rn(m, s_tab[nh - 1]) : m;
  const float span = __fsub_rn(hi, lo);
  const float per = (float)kNL / span;
  auto t2 = [&](int j) {
    return __fsub_rn(hi, __fmul_rn(span, s_tab[kNL + j]));
  };
  const int nh2 = k1_level_misses(sc, s_hist[1], kq, t2, [&](float x) {
    return clamp_bin((hi - x) * per);
  });
  return nh2 < kNL ? t2(nh2) : lo;
}

// A selection block's rows [r0, r0 + n) (whole chunks of G rows, n <=
// kRowRegs * kSelThreads): rows r0 + kRowRegs*tid + q, so a warp holds
// 32*kRowRegs consecutive rows. v, stats and scales are loaded as they
// are before the cutoff search and first used after it, so their latency
// overlaps the search's own loads.
struct HeldRows {
  float vi[kRowRegs], st[kRowRegs], sc[kRowRegs];

  __device__ __forceinline__ void load(const float* __restrict__ v,
                                       const float* __restrict__ stats,
                                       const float* __restrict__ scales,
                                       int r0, int n) {
#pragma unroll
    for (int q = 0; q < kRowRegs; ++q) {
      const int r = kRowRegs * threadIdx.x + q;
      const bool in = r < n;
      vi[q] = in ? v[r0 + r] : 0.f;
      st[q] = in ? stats[r0 + r] : 0.f;
      sc[q] = (in && scales != nullptr) ? scales[r0 + r] : 1.f;
    }
  }

  // u of the rows (x = stats * |v| selected where above the cutoff, u =
  // v * scale there) and, on return, each chunk's selected mass in
  // s_mass[chunk - r0 / G] (f64: exact in any order). Where a warp's rows
  // lie in one chunk (G a multiple of 32*kRowRegs) its lanes' masses add in
  // one warp sum into s_warp[warp], and after a barrier thread c adds its
  // chunk's warps; else each selected row adds its own into s_mass, zeroed
  // before.
  __device__ __forceinline__ void select(float cutoff, bool scaled, int G,
                                         int r0, int n,
                                         __nv_bfloat16* __restrict__ u,
                                         double* s_mass, double* s_warp) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool whole = G % (32 * kRowRegs) == 0;
    double m = 0.0;
#pragma unroll
    for (int q = 0; q < kRowRegs; ++q) {
      const int r = kRowRegs * tid + q;
      if (r >= n) break;
      const float x = __fmul_rn(st[q], fabsf(vi[q]));
      const bool sel = x > cutoff;
      const float uv = scaled ? __fmul_rn(vi[q], sc[q]) : vi[q];
      u[r0 + r] = __float2bfloat16_rn(sel ? uv : 0.f);
      if (sel) {
        if (whole)
          m += (double)x;
        else
          atomicAdd(&s_mass[r / G], (double)x);
      }
    }
    if (whole) {
      if (kRowRegs * 32 * warp < n) {
        m = warp_sum(m);
        if (lane == 0) s_warp[warp] = m;
      }
      __syncthreads();
      const int per = G / (32 * kRowRegs);  // warps a chunk
      if (tid < n / G) {
        double s = 0.0;
        for (int w = tid * per; w < (tid + 1) * per; ++w) s += s_warp[w];
        s_mass[tid] = s;
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
  __shared__ double s_warp[kSelWarps];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  // a programmatic dependent of the work before it: scheduled while that
  // drains, it reads nothing before it has ended (v, the effort and the
  // instance may be its outputs), and lets the stream be scheduled after
  wait_prior();
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
  const float cutoff = k1_find_cutoff(v, P, stride, probes, eff, tables);
  if (held)
    rows.select(cutoff, scales != nullptr, G, r0, n, u, s_seg, s_warp);
  else
    chunk_masses(v, stats, scales, cutoff, G, c0, c1 - c0, u, s_seg);
  // one block holds every chunk's mass: C from shared memory, with no
  // ticket and no round trip through device memory
  if (gridDim.x == 1) {
    if (tid < 32) {
      const int C = chunk_prefix_len(s_seg, nc, tau);
      if (tid == 0) {
        c_out[0] = C;
        cutoff_out[0] = cutoff;
      }
    }
    return;
  }
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
    const __nv_bfloat16* __restrict__ u, int rows_per_block, int pf_rows,
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
  // the block's rows below pf_rows, which every C streams first, asked
  // into L2 while the selection runs (HBM is otherwise idle until C is
  // known); a block that starts after the selection asks for them just
  // before it loads them
  if (active)
    for (int r = r0 + warp; r < min(r0 + rows_per_block, pf_rows);
         r += kWarps)
      prefetch_l2(vals + (size_t)r * row_bytes + cb);
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
// (select_plan: one, or at most one an SM). mass is the per-card scratch:
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
  err = launch_dependent(
      k1_select_kernel, dim3(blocks), dim3(kSelThreads), st, v, P, stride,
      probes, stats, scales, eff_q, inst, tables, G, nc, tau, ub, c_out,
      cutoff_out, mass, reinterpret_cast<unsigned int*>(mass + kMaxChunks));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((row_bytes + 511) / 512,
                  (in_dim + rows_per_block - 1) / rows_per_block);
  const int pf_rows = (int)min(
      (long long)((nc * kPrefetchNum + kPrefetchDen - 1) / kPrefetchDen) * G,
      kPrefetchBytes / row_bytes);
  const uint8_t* vb = static_cast<const uint8_t*>(vals);
  const __nv_bfloat16* uc = ub;
  const int32_t* cc = c_out;
  if (kind == kBf16)
    err = launch_dependent(k1_stream_kernel<kBf16>, grid,
                           dim3(kStreamThreads), st, vb, inst, in_dim,
                           row_bytes, G, cc, uc, rows_per_block, pf_rows,
                           partial, width);
  else if (kind == kInt8)
    err = launch_dependent(k1_stream_kernel<kInt8>, grid,
                           dim3(kStreamThreads), st, vb, inst, in_dim,
                           row_bytes, G, cc, uc, rows_per_block, pf_rows,
                           partial, width);
  else
    err = launch_dependent(k1_stream_kernel<kInt4>, grid,
                           dim3(kStreamThreads), st, vb, inst, in_dim,
                           row_bytes, G, cc, uc, rows_per_block, pf_rows,
                           partial, width);
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
