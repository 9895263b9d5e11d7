"""bucketMul: effort-truncated vector-matrix multiply (public API and the
plain reference path), and its batched form for prefill and batched
decode (bucket_matmul, whose kernel route is K2,
kernels/fused_stream.mxu_matvec_batch).

Execution paths of bucket_matvec, selected by `impl`:
  - "dense":     effort >= 1 fast path, a bf16 matvec on the dense copy.
  - "reference": the exact bucketMul semantics as plain tensor ops (the
                 counterpart of the JAX package's "jnp" path): reads all
                 weights; used for correctness and as the quality oracle.
  - "kernel":    the hand-written kernel (counterpart of "pallas"): for the
                 row-prefix layout K1 (kernels/fused_stream.mxu_matvec);
                 for bucket_size >= 2 K4 (fused_stream.fused_matvec) where
                 its limits hold, else select_stream + K5
                 (kernels/prefix_stream.stream_matvec). On CPU tensors a
                 kernel runs its plain version, so the CPU tests exercise
                 the kernel's semantics.
  - "stream":    select_stream + K5 (bucket_size >= 2); on the row-prefix
                 layout, which has no positions to stream by rank, the
                 reference route (as the JAX package's "stream" takes
                 bucket_matvec_jnp(exact_cutoff=False) there).
  - "gather":    select_blocks + K6 (kernels/gather_dma.gather_matvec_dma),
                 the exact-coverage block gather (bucket_size >= 2, bf16
                 or int8); the block list's capacity comes from a python
                 float effort.
  - "plain":     the plain PyTorch version of what "kernel" runs, on any
                 device: the kernel's exact semantics without the kernel,
                 to hold the kernel route against on the card.

The instance `expert` (the layer, or layer * E + expert of an MoE FFN) is
an int or a 0-d int32 tensor on the weights' device, as a routed expert
comes out of the gate's top-k. A tensor is read on the device on every
route but "stream" and "gather" (K1 and K4 read it in the kernel, the
plain routes index with it), so routed decode waits on no host read;
those two read it on the host, once a call (their selections, plain
tensor ops, take an int).
"""

from __future__ import annotations

import torch

from effort_tpu_torch.kernels.fused_stream import (fused_matvec,
                                                   fused_matvec_ref,
                                                   mxu_matvec,
                                                   mxu_matvec_batch,
                                                   mxu_matvec_batch_ref,
                                                   mxu_matvec_ref,
                                                   slot_efforts,
                                                   supports_fused)
from effort_tpu_torch.kernels.gather_dma import gather_matvec_dma
from effort_tpu_torch.kernels.prefix_stream import (body_limits,
                                                    select_stream,
                                                    stream_matvec,
                                                    stream_matvec_ref)
from effort_tpu_torch.ops.effort import (compute_cutoff, compute_cutoff_exact,
                                         row_rank_counts, select_blocks)
from effort_tpu_torch.ops.layouts import BucketedMatrix, strided_sample, take


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k] @ b [k, n], both bf16, accumulated and returned in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def dense_matvec(v: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """v [in] @ wt [in, out] -> f32 [out] (bf16 weights, f32 accumulate)."""
    return mm_f32(v.to(torch.bfloat16)[None], wt)[0]


def _add_outliers(bm: BucketedMatrix, y: torch.Tensor, vp: torch.Tensor,
                  expert) -> torch.Tensor:
    """y[..., col] += w * v[..., row] for the exact int4 outlier table
    (leading axes are slots). An outlier whose row truncate_bucketed
    dropped (row >= in_dim) adds exactly 0: its index is clamped and its
    term masked on the device, with no host sync."""
    if bm.outlier_vals is None:
        return y
    oi = take(bm.outlier_idx, expert).long()
    rows = oi[:, 0]
    x = take(bm.outlier_vals, expert) * vp[
        ..., rows.clamp(max=bm.in_dim - 1)]
    return y.index_add(-1, oi[:, 1], torch.where(rows < bm.in_dim, x, 0.0))


def bucket_matvec_ref(bm: BucketedMatrix, v: torch.Tensor, effort,
                      expert=0, exact_cutoff: bool = True) -> torch.Tensor:
    """Exact bucketMul semantics as dense tensor ops (reads all weights)."""
    K, G, B = bm.n_ranks, bm.chunk_rows, bm.bucket_size
    nb = bm.n_buckets
    v = bm.permute_v(v, expert).to(torch.float32)
    cf = compute_cutoff_exact if exact_cutoff else compute_cutoff
    cutoff = cf(strided_sample(v, bm.in_dim, bm.probes.shape[1]),
                take(bm.probes, expert), effort)
    n = row_rank_counts(v, take(bm.stats, expert), cutoff)    # [in]
    ranks = torch.arange(K, dtype=torch.int32, device=v.device)
    u = v[None, :] * (ranks[:, None] < n[None, :])             # [K, in]
    if bm.scales is not None:
        u = u * take(bm.scales, expert).T

    vals = take(bm.vals_unpacked()[:-1].reshape(
        bm.n_experts, K, bm.n_chunks, G, nb), expert)
    if B == 1:
        # row-prefix layout: positions are identically zero and the
        # semantics collapse to one matmul u_0 @ W
        y = u[0] @ vals[0].reshape(bm.in_dim, nb).to(torch.float32)
        return _add_outliers(bm, y, v, expert)

    pos = take(bm.pos_unpacked()[:-1].reshape(
        bm.n_experts, K, bm.n_chunks, G, nb), expert)
    y = torch.zeros((nb, B), dtype=torch.float32, device=v.device)
    for k in range(K):
        vk = vals[k].reshape(bm.in_dim, nb).to(torch.float32)
        pk = pos[k].reshape(bm.in_dim, nb).long()
        contrib = u[k][:, None] * vk                           # [in, nb]
        oh = torch.nn.functional.one_hot(pk, B).to(torch.float32)
        y = y + torch.einsum("ij,ijp->jp", contrib, oh)
    return _add_outliers(bm, y.reshape(bm.out_dim), v, expert)


def _tile_blocks(bm: BucketedMatrix) -> int:
    """Streaming tile of the rank-prefix kernels (chunks a tile): the
    largest of 8, 4, 2, 1 that divides the chunk count."""
    for t in (8, 4, 2, 1):
        if bm.n_chunks % t == 0:
            return t
    return 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def gather_capacity(bm: BucketedMatrix, effort: float) -> int:
    """max_blocks of the gather route, from a python float effort: the
    budget min(1, 2.6 effort + 0.05) of the instance's blocks, at least 8,
    in multiples of 8, at most all blocks rounded up to 8."""
    budget = min(1.0, effort * 2.6 + 0.05)
    n = _round_up(max(8, int(bm.blocks_per_expert * budget)), 8)
    return min(n, _round_up(bm.blocks_per_expert, 8))


def _rank_prefix(bm: BucketedMatrix, v: torch.Tensor, effort, expert,
                 impl: str) -> torch.Tensor:
    """The routes "kernel", "plain", "stream" and "gather" on a rank-prefix
    container (bucket_size >= 2), outliers not yet added."""
    tgb = _tile_blocks(bm)
    fused = impl in ("kernel", "plain") and supports_fused(bm, tgb)
    if not fused and not isinstance(expert, int):
        expert = int(expert)       # the host read of the module docstring
    if impl == "gather":
        if not isinstance(effort, (int, float)):
            raise TypeError("impl='gather' sizes its block list from a "
                            "python float effort, not a tensor")
        sel = select_blocks(bm, v, effort, expert,
                            gather_capacity(bm, float(effort)))
        return gather_matvec_dma(bm, sel)
    if fused:
        fn = fused_matvec if impl == "kernel" else fused_matvec_ref
        return fn(bm, v, effort, expert, tile_blocks=tgb)
    sel = select_stream(bm, v, effort, expert, tile_blocks=tgb)
    fn = stream_matvec_ref if impl == "plain" else stream_matvec
    return fn(bm, sel, tgb)


def bucket_matvec(bm: BucketedMatrix, v: torch.Tensor, effort,
                  expert=0, impl: str = "auto") -> torch.Tensor:
    """Effort-truncated matvec: v [in] -> f32 [out_dim].

    effort: a python float, an f32 tensor, or a 16.16 int32 tensor
    (ops.effort.effort_q16) — the last is what the kernels take, so a
    caller that converts once per step moves the knob with no host work
    (the "gather" route alone needs a python float).
    "auto" takes the dense copy for a python-float effort >= 0.999 when one
    is present, and the kernel otherwise (on CUDA tensors the CUDA kernel,
    on CPU tensors its plain version); on a rank-prefix container whose
    shapes neither K4 nor K5 takes, the reference (as the JAX package's
    "auto" takes "jnp" where its kernel does not fit)."""
    if impl == "auto":
        if (isinstance(effort, (int, float)) and effort >= 0.999
                and bm.dense is not None):
            impl = "dense"
        elif bm.bucket_size == 1 or body_limits(
                bm, _tile_blocks(bm) * bm.chunk_rows) is None:
            impl = "kernel"
        else:
            impl = "reference"
    if impl == "dense":
        if bm.dense is None:
            raise ValueError("dense path needs weights built with "
                             "keep_dense")
        return dense_matvec(bm.permute_v(v, expert), take(bm.dense, expert))
    if impl == "reference":
        # the kernels' approximate cutoff, so reference-vs-kernel
        # comparisons select the same rows
        return bucket_matvec_ref(bm, v, effort, expert, exact_cutoff=False)
    if impl not in ("kernel", "plain", "stream", "gather"):
        raise ValueError(f"impl {impl!r}")
    if bm.bucket_size != 1:
        y = _rank_prefix(bm, v, effort, expert, impl)
    elif impl in ("kernel", "plain"):
        fn = mxu_matvec if impl == "kernel" else mxu_matvec_ref
        y = fn(bm, v, effort, expert)
    elif impl == "stream":
        # the reference adds the outliers itself
        return bucket_matvec_ref(bm, v, effort, expert, exact_cutoff=False)
    else:
        raise ValueError(f"impl {impl!r} needs bucket_size >= 2 (the "
                         f"row-prefix layout has no positions)")
    if bm.outlier_vals is not None:
        y = _add_outliers(bm, y, bm.permute_v(v, expert), expert)
    return y


def bucket_matmul(bm: BucketedMatrix, V: torch.Tensor, effort,
                  expert=0, impl: str = "auto") -> torch.Tensor:
    """Batched effort-truncated matmul: V [T, in] -> f32 [T, out_dim].

    effort: a python float, an f32 tensor (scalar, or [T]: one effort per
    row, as a batched decode step gives its slots).
    The routes are those of bucket_matvec: "auto" takes the dense copy for
    a python-float effort >= 0.999 when one is present, the kernel
    otherwise on the row-prefix layout, and the reference on a rank-prefix
    container (the JAX package has no batched rank-prefix kernel and takes
    its per-row "jnp" semantics there); "kernel" is K2 on CUDA tensors and
    its plain version on CPU tensors (no padding of T: the kernel takes any
    T; K2 takes an int instance); "plain" is K2's plain version on any
    device; "reference" is the per-row bucketMul semantics (every weight
    read), and so are "stream" and "gather" on either layout (the JAX
    package's bucket_matmul takes its per-row "jnp" semantics for every
    impl but "dense" and "pallas"); "dense" the bf16 matmul on the dense
    copy."""
    if impl == "auto":
        if (isinstance(effort, (int, float)) and effort >= 0.999
                and bm.dense is not None):
            impl = "dense"
        elif bm.bucket_size == 1:
            impl = "kernel"
        else:
            impl = "reference"
    if impl == "dense":
        if bm.dense is None:
            raise ValueError("dense path needs weights built with "
                             "keep_dense")
        return mm_f32(bm.permute_v(V, expert).to(torch.bfloat16),
                      take(bm.dense, expert))
    if impl in ("reference", "stream", "gather"):
        effs = ([effort] * V.shape[0] if isinstance(effort, (int, float))
                else slot_efforts(effort, V.shape[0], V.device))
        return torch.stack([
            bucket_matvec_ref(bm, V[t], effs[t], expert, exact_cutoff=False)
            for t in range(V.shape[0])])
    if impl in ("kernel", "plain"):
        if bm.bucket_size != 1:
            raise NotImplementedError(
                "K2 is row-prefix only (bucket_size=1); a rank-prefix "
                "container takes impl='reference' (the default)")
        fn = mxu_matvec_batch if impl == "kernel" else mxu_matvec_batch_ref
        y = fn(bm, V, effort, expert)
        if bm.outlier_vals is not None:
            y = _add_outliers(bm, y, bm.permute_v(V, expert), expert)
        return y
    raise ValueError(f"impl {impl!r}")
