"""Carrying weights across from the JAX package.

The JAX package's parameters arrive as numpy arrays: a BucketedMatrix as a
dict of its field arrays plus its meta fields, a ModelWeights as a nested
dict ({"tok_embeddings", "norm", "output", "output_q", "output_qscale",
"layers": {"attn_norm", "ffn_norm", "wq", ..., "w13"}}). numpy has no
bfloat16 that torch reads, so bf16 arrays arrive as their uint16 bit
pattern: every uint16 array becomes a torch.bfloat16 tensor (no field of
these containers holds genuine uint16 data). Flattening a JAX dataclass
into such dicts is left to the caller, so this package imports no JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from effort_tpu_torch.models.transformer import (LayerWeights, ModelWeights,
                                                 PROJ_FIELDS)
from effort_tpu_torch.ops.layouts import (META_FIELDS, TENSOR_FIELDS,
                                          BucketedMatrix)


def tensor_from_numpy(a) -> Optional[torch.Tensor]:
    """A numpy array as a torch tensor of its own memory (uint16 -> bf16)."""
    if a is None:
        return None
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.view(torch.bfloat16) if t.dtype == torch.uint16 else t


def bucketed_from_numpy(d: Optional[dict]) -> Optional[BucketedMatrix]:
    if d is None:
        return None
    return BucketedMatrix(
        **{f: tensor_from_numpy(d.get(f)) for f in TENSOR_FIELDS},
        **{m: d[m] for m in META_FIELDS})


def model_weights_from_numpy(d: dict) -> ModelWeights:
    lw = d["layers"]
    layers = LayerWeights(
        attn_norm=tensor_from_numpy(lw["attn_norm"]),
        ffn_norm=tensor_from_numpy(lw["ffn_norm"]),
        ffn_gate=tensor_from_numpy(lw.get("ffn_gate")),
        **{f: bucketed_from_numpy(lw.get(f)) for f in PROJ_FIELDS})
    return ModelWeights(
        tok_embeddings=tensor_from_numpy(d["tok_embeddings"]),
        norm=tensor_from_numpy(d["norm"]),
        output=tensor_from_numpy(d.get("output")),
        layers=layers,
        output_q=tensor_from_numpy(d.get("output_q")),
        output_qscale=tensor_from_numpy(d.get("output_qscale")))
