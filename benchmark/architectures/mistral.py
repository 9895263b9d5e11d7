"""The Mistral / Mixtral decoder, as the harness runs it.

A configuration names its architecture by its `model_type`, and the
harness loads architectures/<model_type>.py (spec.Manifest.architecture)
and reaches the model only through the names of `__all__`:

  dims(cfg_file)                  the configuration's shapes (Dims); the
                                  traffic, drivers and readings read
                                  n_layers, dim, vocab and max_seq_len
  build(name, dims, bucket, seed, device)
                                  (weights, port config, raw weights):
                                  the program through its own assembly
  state_shapes(dims, rows)        [(shape, dtype)] of each tensor of cache
                                  rows that one judged sequence keeps,
                                  rows on axis 1
  state_of(owner, slot, start, n) the program's tensors of those rows, in
                                  the same order: a ChatSession's (slot
                                  None) or one BatchEngine slot's
  Reference                       the plain f32 reference
                                  (reference/model.py)
  attention, head, token_overhead the work counts that step_mfu adds

The raw weights are harness/weights.RawModel, this decoder's recipe.
Mixtral is the same module (mixtral.py re-exports it): the build and the
reference branch on n_experts.
"""

from __future__ import annotations

import dataclasses

import torch

from harness.weights import RawModel
from harness.work import Work
from reference.model import Reference

__all__ = ("Dims", "dims", "build", "state_shapes", "state_of",
           "Reference", "attention", "head", "token_overhead")


@dataclasses.dataclass(frozen=True)
class Dims:
    """A model configuration's shapes, read from its published keys."""
    dim: int
    hidden: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    n_experts: int
    top_k: int
    norm_eps: float
    rope_theta: float
    max_seq_len: int
    sliding_window: object


def dims(cfg_file: dict) -> Dims:
    """Dims from a configuration file's Hugging Face keys."""
    cfg = cfg_file
    heads = cfg["num_attention_heads"]
    return Dims(
        dim=cfg["hidden_size"], hidden=cfg["intermediate_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=heads,
        n_kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        vocab=cfg["vocab_size"], n_experts=cfg.get("num_local_experts", 1),
        top_k=cfg.get("num_experts_per_tok", 1) if
        cfg.get("num_local_experts", 1) > 1 else 1,
        norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        max_seq_len=cfg["max_position_embeddings"],
        sliding_window=cfg.get("sliding_window"))


# ---- the program ----

def port_config(name: str, d: Dims):
    """The port's ModelConfig of a configuration's shapes."""
    from effort_tpu_torch.config import ModelConfig
    return ModelConfig(
        name=name, dim=d.dim, hidden_dim=d.hidden, n_layers=d.n_layers,
        n_heads=d.n_heads, n_kv_heads=d.n_kv_heads, head_dim=d.head_dim,
        vocab_size=d.vocab, norm_eps=d.norm_eps, rope_theta=d.rope_theta,
        max_seq_len=d.max_seq_len, sliding_window=d.sliding_window,
        n_experts=d.n_experts, n_experts_per_tok=max(d.top_k, 1))


def raw_weights(src: RawModel) -> dict:
    """The raw dict the port's assemble_weights takes, each projection a
    RawWeight whose instances come from src's seeded blocks."""
    from effort_tpu_torch.models.transformer import RawWeight
    d, dev = src.d, src.device

    def lazy(name):
        return RawWeight(
            lambda s, n: torch.stack([src.block(name, s + i)
                                      for i in range(n)]),
            src.n_inst(name), *src.shape(name))

    raw = {n: lazy(n) for n in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")}
    raw.update(
        tok_embeddings=src.embeddings(), output=src.head(),
        ffn_gate=(torch.stack([src.gate(l) for l in range(d.n_layers)])
                  if d.n_experts > 1 else None),
        attn_norm=torch.ones((d.n_layers, d.dim), device=dev),
        ffn_norm=torch.ones((d.n_layers, d.dim), device=dev),
        norm=torch.ones((d.dim,), device=dev))
    return raw


def build(name: str, dims: Dims, bucket: dict, seed: int, device):
    """(weights, port ModelConfig, RawModel): the port's model of one
    configuration and seed, bucketized on `device` as the configuration's
    `bucket` layout states (bucket_size, chunk_rows, probes, dtype), with
    fused wqkv and w13, the baked calibration relayout and the int8 head
    with its exact rescore. No dense copies are kept."""
    from effort_tpu_torch.config import BucketConfig
    from effort_tpu_torch.models.transformer import (assemble_weights,
                                                     quantize_head)
    src = RawModel(dims, seed, device)
    cfg = port_config(name, dims)
    bcfg = BucketConfig(bucket_size=bucket["bucket_size"],
                        chunk_rows=bucket["chunk_rows"],
                        probes=bucket["probes"], dtype=bucket["dtype"])
    w = assemble_weights(raw_weights(src), cfg, bcfg, rms_m=src.rms_m,
                         rms_f=src.rms_f, fuse=True)
    return quantize_head(w), cfg, src


# ---- the program's state ----

def state_shapes(d: Dims, rows: int) -> list:
    """A judged sequence's keys and values: bf16 [L, rows, KV, D] each,
    as the cache holds them."""
    shape = (d.n_layers, rows, d.n_kv_heads, d.head_dim)
    return [(shape, torch.bfloat16)] * 2


def state_of(owner, slot, start: int, n: int) -> tuple:
    """(keys, values) of positions start .. start + n - 1 in the owner's
    caches: a ChatSession's [L, S, KV, D] (slot None), or slot `slot` of
    a BatchEngine's [L, B, S, KV, D]."""
    if slot is None:
        return (owner.k_cache[:, start:start + n],
                owner.v_cache[:, start:start + n])
    return (owner.k_cache[:, slot, start:start + n],
            owner.v_cache[:, slot, start:start + n])


# ---- work counts (the rule of harness/work.py) ----

def attention(n_live: int, n_keys: int, T: int, d: Dims) -> Work:
    """T queries over their live keys: each live key and value (bf16)
    read once, the queries and outputs (f32) once; 4 H D operations per
    live (query, key) pair."""
    H, KV, D = d.n_heads, d.n_kv_heads, d.head_dim
    return Work(bytes=2 * n_keys * KV * D * 2 + 2 * T * H * D * 4,
                flops=4.0 * H * D * n_live)


def head(d: Dims, T: int = 1) -> Work:
    """The int8 head for T rows: the codes and column scales once."""
    return Work(bytes=d.vocab * d.dim + d.vocab * 4
                + T * (d.dim * 4 + d.vocab * 4),
                flops=2.0 * T * d.vocab * d.dim)


def token_overhead(d: Dims, T: int = 1) -> Work:
    """Embedding rows, norm weights and router of T tokens through every
    layer, and the new key and value rows written."""
    L, E = d.n_layers, d.n_experts
    w = Work(bytes=T * d.dim * 2 + (2 * L + 1) * d.dim * 4
             + T * L * 2 * d.n_kv_heads * d.head_dim * 2)
    if E > 1:
        w += Work(bytes=L * d.dim * E * 2,
                  flops=2.0 * T * L * d.dim * E)
    return w
