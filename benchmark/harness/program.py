"""The system under test: the port's model built from the benchmark's raw
weights, through the port's own set-up (assemble_weights, quantize_head).

This is the one module of the harness that builds the program; the
drivers take what it returns. The JAX package is never imported.
"""

from __future__ import annotations

import torch

from harness.weights import RawModel


def port_config(name: str, dims):
    """The port's ModelConfig of a configuration's shapes."""
    from effort_tpu_torch.config import ModelConfig
    return ModelConfig(
        name=name, dim=dims.dim, hidden_dim=dims.hidden,
        n_layers=dims.n_layers, n_heads=dims.n_heads,
        n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
        vocab_size=dims.vocab, norm_eps=dims.norm_eps,
        rope_theta=dims.rope_theta, max_seq_len=dims.max_seq_len,
        sliding_window=dims.sliding_window, n_experts=dims.n_experts,
        n_experts_per_tok=max(dims.top_k, 1))


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


def build(name: str, dims, bucket: dict, seed: int, device):
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
