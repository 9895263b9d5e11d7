"""Block-gather effort matvec with unpacked positions (K7): the wrapper of
csrc/gather_mul.cu and its plain PyTorch version.

K7 replaces effort_tpu/kernels/gather_mul.py:gather_bucket_matvec ->
_gather_call -> _kernel: K6's function (kernels/gather_dma.py), with the
positions read one int8 a column (BucketedMatrix.pos_unpacked()) instead of
packed. No path of the JAX package runs it; its tests do. Bound by the
gathered bytes (values and position bytes) over the card's memory rate.
"""

from __future__ import annotations

from typing import Optional

import torch

from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels.gather_dma import (_refuse_int4,
                                                 gather_launch,
                                                 gather_product_ref)
from effort_tpu_torch.ops.effort import BlockSelection
from effort_tpu_torch.ops.layouts import BucketedMatrix

LAUNCHES["gather_bucket_matvec"] = 0


def unpacked_positions(bm: BucketedMatrix) -> torch.Tensor:
    """The positions K7 reads: int8 [E*K*nc+1, G, OB], contiguous."""
    return bm.pos_unpacked().contiguous()


def gather_bucket_matvec_ref(bm: BucketedMatrix, sel: BlockSelection,
                             pos: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of K7 (pos as in gather_bucket_matvec)."""
    _refuse_int4(bm)
    pos = unpacked_positions(bm) if pos is None else pos
    return gather_product_ref(bm, sel, pos)


def gather_bucket_matvec(bm: BucketedMatrix, sel: BlockSelection,
                         pos: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The selected blocks against u, one position byte a column: y
    [OB*B] f32. pos: unpacked_positions(bm), made once by a caller that
    calls often (unpacked here when not given).

    CPU tensors run the plain version (gather_bucket_matvec_ref); CUDA
    tensors launch the kernel, on the current stream without
    synchronising, or raise. int4 values raise on either."""
    if not sel.u_scaled.is_cuda:
        return gather_bucket_matvec_ref(bm, sel, pos)
    _refuse_int4(bm)
    pos = unpacked_positions(bm) if pos is None else pos
    return gather_launch("gather_mul", "effort_gather_bucket_matvec",
                         "gather_bucket_matvec", bm, sel, pos, packed=False)
