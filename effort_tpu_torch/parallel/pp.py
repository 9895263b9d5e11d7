"""Pipeline parallelism: contiguous layer stages over a "pp" axis, with
round-robin microbatches for decode (the JAX package's parallel/pp.py, one
process a rank).

  - rank (stage) s holds layers [s * L_loc, (s + 1) * L_loc) and their KV
    cache for every microbatch, [L_loc, M, S, KV, D];
  - M = n_pp independent sequences decode together: at tick k stage s runs
    microbatch (s - k) mod M when k in [s, s + M), then the activations
    move one hop along the ring (ppermute); after 2 n_pp - 1 ticks every
    microbatch has advanced one token (the GPipe round robin). The tick,
    the stage and so whether it runs are host ints: a step reads nothing
    back from the card;
  - stage 0 embeds, the last stage applies the final norm and the bf16
    head; the logits are summed over the axis, only the last stage's
    nonzero.
Effort is untouched: each stage's dispatch is local to its own layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.models.transformer import (LayerWeights, ModelWeights,
                                                 embed, forward_layers,
                                                 resolve_device, rms_norm,
                                                 synth_raw_weights)
from effort_tpu_torch.ops.bucketmul import dense_matvec
from effort_tpu_torch.parallel import collectives
from effort_tpu_torch.parallel.multihost import device_type_of
from effort_tpu_torch.parallel.tp import (bucketize_slices, part, shard_of,
                                          stack_shards)


def make_pp_mesh(n_pp: int, device="cpu"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type_of(device), (n_pp,),
                            mesh_dim_names=("pp",))


def local_config(cfg: ModelConfig, n_pp: int) -> ModelConfig:
    if cfg.n_layers % n_pp:
        raise ValueError(f"{cfg.n_layers} layers over {n_pp} stages")
    return dataclasses.replace(cfg, n_layers=cfg.n_layers // n_pp)


def make_pp_weights(cfg: ModelConfig, bcfg: BucketConfig, n_pp: int,
                    seed: int = 0, scale: float = 0.02,
                    rank: Optional[int] = None, device=None
                    ) -> Tuple[ModelWeights, ModelConfig]:
    """Random-weight pp model from synth_raw_weights(cfg, seed): the layer
    containers, norms and gate of each stage's layers (bucketized per
    instance, so slices of the single-device model's); embeddings, final
    norm and head replicated. rank=None: the stages concatenated on axis
    0 (pp_local splits them). Made on `device` (the card unless named)."""
    dev = resolve_device(device)
    raw = synth_raw_weights(cfg, seed=seed, scale=scale, device=dev)
    ranks = range(n_pp) if rank is None else [rank]
    cfg_local = local_config(cfg, n_pp)
    L_loc = cfg_local.n_layers

    def stages(name, per_layer):
        return stack_shards([bucketize_slices(
            raw[name], bcfg, [(p * L_loc * per_layer, L_loc * per_layer)])
            for p in ranks])

    def rows(t):
        return None if t is None else torch.cat(
            [t[p * L_loc:(p + 1) * L_loc] for p in ranks])

    E = cfg.n_experts
    gate = raw["ffn_gate"]
    layers = LayerWeights(
        attn_norm=rows(raw["attn_norm"]).to(torch.float32),
        ffn_norm=rows(raw["ffn_norm"]).to(torch.float32),
        wq=stages("wq", 1), wk=stages("wk", 1), wv=stages("wv", 1),
        wo=stages("wo", 1), w1=stages("w1", E), w2=stages("w2", E),
        w3=stages("w3", E),
        ffn_gate=None if gate is None else rows(gate).to(torch.bfloat16))
    w = ModelWeights(tok_embeddings=raw["tok_embeddings"].to(torch.bfloat16),
                     norm=raw["norm"].to(torch.float32),
                     output=raw["output"].to(torch.bfloat16), layers=layers)
    return w, cfg_local


def pp_local(w: ModelWeights, n_pp: int, rank: int) -> ModelWeights:
    """Stage `rank` of a global pp layout (the JAX package's pp_specs:
    every layer leaf split on axis 0; embeddings, norm and head whole)."""
    lw = w.layers
    repl = {f.name: part(getattr(lw, f.name), n_pp, rank)
            for f in dataclasses.fields(lw)
            if isinstance(getattr(lw, f.name), torch.Tensor)}
    repl.update({f.name: shard_of(getattr(lw, f.name), n_pp, rank)
                 for f in dataclasses.fields(lw)
                 if getattr(lw, f.name) is not None
                 and f.name not in repl})
    return dataclasses.replace(w, layers=dataclasses.replace(lw, **repl))


def make_pp_caches(cfg: ModelConfig, n_microbatches: int, device,
                   dtype=torch.bfloat16):
    """(k, v) caches [n_layers, M, S, KV, D]; a stage's with its local
    config."""
    shape = (cfg.n_layers, n_microbatches, cfg.max_seq_len, cfg.n_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def pp_decode_step(w_local: ModelWeights, cfg_local: ModelConfig,
                   token_ids, pos, k_cache, v_cache, effort, impl: str,
                   n_pp: int, mesh, axis: str = "pp") -> torch.Tensor:
    """One decode step of the M = n_pp microbatches on a stage.

    token_ids, pos: [M] (int device tensors, or lists of ints): each
    microbatch's token and cache slot. k_cache/v_cache: the stage's
    caches [L_loc, M, S, KV, D], written in place. Returns the logits
    [M, vocab] f32, the same on every stage."""
    M = n_pp
    my = collectives.axis_index(mesh, axis)
    dev = w_local.device
    dim, vocab = w_local.tok_embeddings.shape[1], w_local.output.shape[1]
    perm = [(i, (i + 1) % n_pp) for i in range(n_pp)]
    last = my == n_pp - 1
    h = torch.zeros(dim, dtype=torch.float32, device=dev)
    out = torch.zeros((M, vocab), dtype=torch.float32, device=dev)
    for k in range(2 * M - 1):
        m = (my - k) % M
        if my == 0 and k < M:
            # stage 0 takes microbatch m's embedding at its window's start
            h = embed(w_local, token_ids[m])
        if my <= k < my + M:
            h = forward_layers(w_local, cfg_local, h, pos[m], k_cache[:, m],
                               v_cache[:, m], effort=effort, impl=impl)
            if last:
                out[m] = dense_matvec(rms_norm(h, w_local.norm,
                                               cfg_local.norm_eps),
                                      w_local.output)
        h = collectives.ppermute(h, mesh, axis, perm)
    return collectives.psum(out, mesh, axis)
