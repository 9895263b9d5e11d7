"""Block-gather effort matvec with packed positions (K6): the wrapper of
csrc/gather_dma.cu and its plain PyTorch version.

K6 replaces effort_tpu/kernels/gather_dma.py:gather_matvec_dma -> _kernel:
the exact-coverage alternative to the prefix stream. ops/effort.
select_blocks lists every (chunk, rank) block some selected row needs
(ascending, padded with the all-zero block, capped at max_blocks); the
kernel reads exactly those blocks and their packed positions and scatters
u[k, g, :] times each into y[j*B + p]. Bound by the gathered bytes over the
card's memory rate. bf16 and int8 values only: int4 is refused, as there.
"""

from __future__ import annotations

from typing import Optional

import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.kernels.prefix_stream import (_KIND, body_limits,
                                                    check_instance,
                                                    launch_shape, split_sum)
from effort_tpu_torch.ops.effort import BlockSelection
from effort_tpu_torch.ops.layouts import BucketedMatrix

LAUNCHES["gather_matvec_dma"] = 0


def gather_product_ref(bm: BucketedMatrix, sel: BlockSelection,
                       pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gather's function: y [OB*B] f32 = the blocks sel.block_ids
    against u[(id // nc) % K, id % nc, :], positions from bm.pos (packed)
    or from `pos` (one a column), summed as the kernel sums."""
    K, nc = bm.n_ranks, bm.n_chunks
    ids = sel.block_ids.long()
    packed = pos is None
    splits = launch_shape(bm, ids.shape[0],
                          (bm.pos if packed else pos).shape[2], packed)[2]
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
    ids, u = sel.block_ids, sel.u_scaled
    check_instance(bm, 0, ids, u, pos)
    if ids.dtype != torch.int32 or ids.ndim != 1 or ids.shape[0] < 1 \
            or not ids.is_contiguous():
        raise ValueError(f"block_ids {ids.dtype} {tuple(ids.shape)}: want "
                         f"contiguous int32 [max_blocks]")
    if u.dtype != torch.float32 or tuple(u.shape) != (K, nc, G) \
            or not u.is_contiguous():
        raise ValueError(f"u_scaled {u.dtype} {tuple(u.shape)}: want "
                         f"contiguous f32 {(K, nc, G)}")
    dev = u.device
    n_ids = ids.shape[0]
    prow = pos.shape[2]
    threads, col_blocks, splits = launch_shape(bm, n_ids, prow, packed)
    partial = torch.empty((splits, bm.out_dim), dtype=torch.float32,
                          device=dev)
    y = torch.empty(bm.out_dim, dtype=torch.float32, device=dev)
    _build.kernel_fn(lib, fn, "piipiipipiiiipiiipip")(
        bm.vals.data_ptr(), _KIND[bm.vals.dtype],
        bm.vals.shape[2] * bm.vals.element_size(), pos.data_ptr(), prow,
        bm.bucket_size, ids.data_ptr(), n_ids, u.data_ptr(), K, nc, G,
        bm.n_buckets, partial.data_ptr(), splits, col_blocks, threads,
        y.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
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
