"""bucketMul: effort-truncated vector-matrix multiply (public API and the
plain reference path), and its batched form for prefill and batched
decode (bucket_matmul, whose kernel route is K2,
kernels/fused_stream.mxu_matvec_batch).

Four execution paths, selected by `impl`:
  - "dense":     effort >= 1 fast path, a bf16 matvec on the dense copy.
  - "reference": the exact bucketMul semantics as plain tensor ops (the
                 counterpart of the JAX package's "jnp" path): reads all
                 weights; used for correctness and as the quality oracle.
  - "kernel":    the hand-written kernel (counterpart of "pallas"); for the
                 row-prefix layout that is kernels/fused_stream.mxu_matvec.
                 On CPU tensors it runs the kernel's plain version, so the
                 CPU tests exercise the kernel's semantics.
  - "plain":     the kernel's plain PyTorch version on any device: the
                 kernel's exact semantics without the kernel, to hold the
                 kernel route against on the card.
"""

from __future__ import annotations

import torch

from effort_tpu_torch.kernels.fused_stream import (mxu_matvec,
                                                   mxu_matvec_batch,
                                                   mxu_matvec_batch_ref,
                                                   mxu_matvec_ref,
                                                   slot_efforts)
from effort_tpu_torch.ops.effort import (compute_cutoff, compute_cutoff_exact,
                                         row_rank_counts)
from effort_tpu_torch.ops.layouts import BucketedMatrix, strided_sample


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k] @ b [k, n], both bf16, accumulated and returned in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def dense_matvec(v: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """v [in] @ wt [in, out] -> f32 [out] (bf16 weights, f32 accumulate)."""
    return mm_f32(v.to(torch.bfloat16)[None], wt)[0]


def _add_outliers(bm: BucketedMatrix, y: torch.Tensor, vp: torch.Tensor,
                  expert: int) -> torch.Tensor:
    """y[..., col] += w * v[..., row] for the exact int4 outlier table
    (leading axes are slots)."""
    if bm.outlier_vals is None:
        return y
    oi = bm.outlier_idx[expert].long()
    return y.index_add(-1, oi[:, 1],
                       bm.outlier_vals[expert] * vp[..., oi[:, 0]])


def bucket_matvec_ref(bm: BucketedMatrix, v: torch.Tensor, effort,
                      expert: int = 0,
                      exact_cutoff: bool = True) -> torch.Tensor:
    """Exact bucketMul semantics as dense tensor ops (reads all weights)."""
    K, G, B = bm.n_ranks, bm.chunk_rows, bm.bucket_size
    nb = bm.n_buckets
    v = bm.permute_v(v, expert).to(torch.float32)
    cf = compute_cutoff_exact if exact_cutoff else compute_cutoff
    cutoff = cf(strided_sample(v, bm.in_dim, bm.probes.shape[1]),
                bm.probes[expert], effort)
    n = row_rank_counts(v, bm.stats[expert], cutoff)          # [in]
    ranks = torch.arange(K, dtype=torch.int32, device=v.device)
    u = v[None, :] * (ranks[:, None] < n[None, :])             # [K, in]
    if bm.scales is not None:
        u = u * bm.scales[expert].T

    vals = bm.vals_unpacked()[:-1].reshape(bm.n_experts, K, bm.n_chunks,
                                           G, nb)[expert]
    if B == 1:
        # row-prefix layout: positions are identically zero and the
        # semantics collapse to one matmul u_0 @ W
        y = u[0] @ vals[0].reshape(bm.in_dim, nb).to(torch.float32)
        return _add_outliers(bm, y, v, expert)

    pos = bm.pos_unpacked()[:-1].reshape(bm.n_experts, K, bm.n_chunks, G,
                                         nb)[expert]
    y = torch.zeros((nb, B), dtype=torch.float32, device=v.device)
    for k in range(K):
        vk = vals[k].reshape(bm.in_dim, nb).to(torch.float32)
        pk = pos[k].reshape(bm.in_dim, nb).long()
        contrib = u[k][:, None] * vk                           # [in, nb]
        oh = torch.nn.functional.one_hot(pk, B).to(torch.float32)
        y = y + torch.einsum("ij,ijp->jp", contrib, oh)
    return _add_outliers(bm, y.reshape(bm.out_dim), v, expert)


def bucket_matvec(bm: BucketedMatrix, v: torch.Tensor, effort,
                  expert: int = 0, impl: str = "auto") -> torch.Tensor:
    """Effort-truncated matvec: v [in] -> f32 [out_dim].

    effort: a python float, an f32 tensor, or a 16.16 int32 tensor
    (ops.effort.effort_q16) — the last is what the kernels take, so a
    caller that converts once per step moves the knob with no host work.
    "auto" takes the dense copy for a python-float effort >= 0.999 when one
    is present, and the kernel otherwise (on CUDA tensors the CUDA kernel,
    on CPU tensors its plain version)."""
    if impl == "auto":
        if (isinstance(effort, (int, float)) and effort >= 0.999
                and bm.dense is not None):
            impl = "dense"
        else:
            impl = "kernel"
    if impl == "dense":
        if bm.dense is None:
            raise ValueError("dense path needs weights built with "
                             "keep_dense")
        return dense_matvec(bm.permute_v(v, expert), bm.dense[expert])
    if impl == "reference":
        # the kernels' approximate cutoff, so reference-vs-kernel
        # comparisons select the same rows
        return bucket_matvec_ref(bm, v, effort, expert, exact_cutoff=False)
    if impl in ("kernel", "plain"):
        if bm.bucket_size != 1:
            raise NotImplementedError(
                "the rank-prefix kernel (bucket_size >= 2) is not ported "
                "yet; use impl='reference'")
        fn = mxu_matvec if impl == "kernel" else mxu_matvec_ref
        y = fn(bm, v, effort, expert)
        if bm.outlier_vals is not None:
            y = _add_outliers(bm, y, bm.permute_v(v, expert), expert)
        return y
    raise ValueError(f"impl {impl!r}")


def bucket_matmul(bm: BucketedMatrix, V: torch.Tensor, effort,
                  expert: int = 0, impl: str = "auto") -> torch.Tensor:
    """Batched effort-truncated matmul: V [T, in] -> f32 [T, out_dim].

    effort: a python float, an f32 tensor (scalar, or [T]: one effort per
    row, as a batched decode step gives its slots).
    The routes are those of bucket_matvec: "auto" takes the dense copy for
    a python-float effort >= 0.999 when one is present and the kernel
    otherwise; "kernel" is K2 on CUDA tensors and its plain version on CPU
    tensors (no padding of T: the kernel takes any T); "plain" is K2's
    plain version on any device; "reference" is the per-row bucketMul
    semantics (every weight read); "dense" the bf16 matmul on the dense
    copy."""
    if impl == "auto":
        if (isinstance(effort, (int, float)) and effort >= 0.999
                and bm.dense is not None):
            impl = "dense"
        else:
            impl = "kernel"
    if impl == "dense":
        if bm.dense is None:
            raise ValueError("dense path needs weights built with "
                             "keep_dense")
        return mm_f32(bm.permute_v(V, expert).to(torch.bfloat16),
                      bm.dense[expert])
    if impl == "reference":
        effs = ([effort] * V.shape[0] if isinstance(effort, (int, float))
                else slot_efforts(effort, V.shape[0], V.device))
        return torch.stack([
            bucket_matvec_ref(bm, V[t], effs[t], expert, exact_cutoff=False)
            for t in range(V.shape[0])])
    if impl in ("kernel", "plain"):
        if bm.bucket_size != 1:
            raise NotImplementedError(
                "the rank-prefix kernel (bucket_size >= 2) is not ported "
                "yet; use impl='reference'")
        fn = mxu_matvec_batch if impl == "kernel" else mxu_matvec_batch_ref
        y = fn(bm, V, effort, expert)
        if bm.outlier_vals is not None:
            y = _add_outliers(bm, y, bm.permute_v(V, expert), expert)
        return y
    raise ValueError(f"impl {impl!r}")
