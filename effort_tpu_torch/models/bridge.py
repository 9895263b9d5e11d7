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


def train_params_from_numpy(d: dict, device=None) -> dict:
    """The JAX trainer's parameter pytree (numpy leaves, nested dicts) as
    the port's trainer params: the same keys, tensors on `device` (the
    CPU unless named)."""
    return {k: (train_params_from_numpy(v, device) if isinstance(v, dict)
                else tensor_from_numpy(v).to(device or "cpu"))
            for k, v in d.items()}


def train_params_to_numpy(p: dict) -> dict:
    """The port's trainer params as the JAX pytree's numpy leaves."""
    return {k: (train_params_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy())
            for k, v in p.items()}


def parallel_weights_from_numpy(d: dict, mode: str, n, rank: int
                                ) -> ModelWeights:
    """Rank `rank`'s local ModelWeights from a JAX global sharded model (the
    nested numpy dict above, from the JAX package's make_*_weights), split
    as its PartitionSpecs split it. mode and n: "tp", "ep", "pp" with the
    axis size; "sp" (replicated); "tp_ep" with (n_tp, n_ep) (rank = t *
    n_ep + e); "tp_sp" with (n_tp, n_sp) (rank = t * n_sp + s; tp's
    weights, replicated over sp)."""
    from effort_tpu_torch.parallel import composed, ep, pp, tp
    w = model_weights_from_numpy(d)
    if mode == "sp":
        return w
    if mode == "tp":
        return tp.tp_local(w, n, rank)
    if mode == "ep":
        return ep.ep_local(w, n, rank)
    if mode == "pp":
        return pp.pp_local(w, n, rank)
    if mode == "tp_ep":
        return composed.tp_ep_local(w, n[0], n[1], rank)
    if mode == "tp_sp":
        return tp.tp_local(w, n[0], rank // n[1])
    raise ValueError(f"mode {mode!r}")
