"""Block-gather effort matvec with packed positions (K6): the wrapper of
csrc/gather_dma.cu and its plain PyTorch version.

K6 replaces effort_tpu/kernels/gather_dma.py:gather_matvec_dma -> _kernel:
the exact-coverage alternative to the prefix stream. ops/effort.
select_blocks lists every (chunk, rank) block some selected row needs
(ascending, padded with the all-zero block, capped at max_blocks); the
kernel reads exactly those blocks and their packed positions and scatters
u[k, g, :] times each into y[j*B + p]. Bound by the gathered bytes over the
card's memory rate; its body (csrc/block_gather.cuh, shared with K7) is the
ring of copy-engine stages K4 and K5 stream through, one block a stage.
The pad ids are not read: the kernel walks min(n_blocks, max_blocks) ids,
n_blocks read on the device. A pad adds u * 0 = +-0 to sums that are
never -0, so this changes no bit (JAX's kernel reads the pads). bf16 and
int8 values only: int4 is refused, as there.
"""

from __future__ import annotations

from typing import Optional

import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.kernels.prefix_stream import (_GATHER_MAX_ROWS, _KIND,
                                                    body_limits,
                                                    check_instance,
                                                    gather_plan, split_sum)
from effort_tpu_torch.ops.effort import BlockSelection
from effort_tpu_torch.ops.layouts import BucketedMatrix

LAUNCHES["gather_matvec_dma"] = 0


def gather_product_ref(bm: BucketedMatrix, sel: BlockSelection,
                       pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gather's function: y [OB*B] f32 = the real blocks of
    sel.block_ids (the first min(n_blocks, max_blocks); the pads after them
    add nothing) against u[(id // nc) % K, id % nc, :], positions from
    bm.pos (packed) or from `pos` (one a column), summed as the kernel sums
    (gather_plan's splits over the whole list)."""
    K, nc = bm.n_ranks, bm.n_chunks
    n_ids = sel.block_ids.shape[0]
    packed = pos is None
    splits = gather_plan(bm, n_ids, (bm.pos if packed else pos).shape[2],
                         packed)[2]
    ids = sel.block_ids[:min(int(sel.n_blocks), n_ids)].long()
    if ids.shape[0] == 0:
        return torch.zeros(bm.out_dim, dtype=torch.float32,
                           device=sel.u_scaled.device)
    return split_sum(bm, ids * bm.chunk_rows,
                     sel.u_scaled[(ids // nc) % K, ids % nc], splits, pos)


def _refuse_int4(bm: BucketedMatrix):
    if bm.vals_packed:
        raise ValueError("int4-packed values: the block gather takes bf16 "
                         "and int8; use the prefix stream")


def gather_matvec_dma_ref(bm: BucketedMatrix,
                          sel: BlockSelection) -> torch.Tensor:
    """Plain PyTorch version of K6."""
    _refuse_int4(bm)
    return gather_product_ref(bm, sel)


def gather_launch(lib: str, fn: str, count: str, bm: BucketedMatrix,
                  sel: BlockSelection, pos: torch.Tensor,
                  packed: bool) -> torch.Tensor:
    """K6's and K7's launch: checks, scratch, the C entry `fn` of
    csrc/<lib>.cu, and one count in LAUNCHES[count]."""
    K, G, nc = bm.n_ranks, bm.chunk_rows, bm.n_chunks
    _refuse_int4(bm)
    why = body_limits(bm, G, None if packed else pos)
    if why:
        raise ValueError(why)
    if G > _GATHER_MAX_ROWS:
        raise ValueError(f"{G} rows a block: the gather takes at most "
                         f"{_GATHER_MAX_ROWS}")
    ids, u, n_blocks = sel.block_ids, sel.u_scaled, sel.n_blocks
    check_instance(bm, 0, ids, u, n_blocks, pos)
    if ids.dtype != torch.int32 or ids.ndim != 1 or ids.shape[0] < 1 \
            or not ids.is_contiguous():
        raise ValueError(f"block_ids {ids.dtype} {tuple(ids.shape)}: want "
                         f"contiguous int32 [max_blocks]")
    if n_blocks.dtype != torch.int32 or n_blocks.numel() != 1:
        raise ValueError(f"n_blocks {n_blocks.dtype} "
                         f"{tuple(n_blocks.shape)}: want one int32")
    if u.dtype != torch.float32 or tuple(u.shape) != (K, nc, G) \
            or not u.is_contiguous():
        raise ValueError(f"u_scaled {u.dtype} {tuple(u.shape)}: want "
                         f"contiguous f32 {(K, nc, G)}")
    dev = u.device
    n_ids = ids.shape[0]
    prow = pos.shape[2]
    threads, col_blocks, splits = gather_plan(bm, n_ids, prow, packed)
    partial = torch.empty((splits, bm.out_dim), dtype=torch.float32,
                          device=dev)
    y = torch.empty(bm.out_dim, dtype=torch.float32, device=dev)
    _build.kernel_fn(lib, fn, "piipiiipippiiiipiiipip")(
        bm.vals.data_ptr(), _KIND[bm.vals.dtype],
        bm.vals.shape[2] * bm.vals.element_size(), pos.data_ptr(), prow,
        bm.vals.shape[0] * G, bm.bucket_size, ids.data_ptr(), n_ids,
        n_blocks.data_ptr(), u.data_ptr(), K, nc, G, bm.n_buckets,
        partial.data_ptr(), splits, col_blocks, threads, y.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES[count] += 1
    return y


def gather_matvec_dma(bm: BucketedMatrix,
                      sel: BlockSelection) -> torch.Tensor:
    """The selected blocks against u, packed positions: y [OB*B] f32.

    CPU tensors run the plain version (gather_matvec_dma_ref); CUDA tensors
    launch the kernel, on the current stream without synchronising, or
    raise. int4 values raise on either."""
    if not sel.u_scaled.is_cuda:
        return gather_matvec_dma_ref(bm, sel)
    return gather_launch("gather_dma", "effort_gather_matvec_dma",
                         "gather_matvec_dma", bm, sel, bm.pos, packed=True)
