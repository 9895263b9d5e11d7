"""DeepSeek-V2 (multi-head latent attention, fine-grained routed experts
plus shared ones, leading dense layers, YaRN), as the harness runs it.

A configuration whose model_type is deepseek_v2 reaches the model through
the names of `__all__` (architectures/mistral.py's docstring says what each
does). Here:
  - the raw weights are harness/weights_deepseek_v2.RawDeepseekV2, and the
    build is the port's own assembly (effort_tpu_torch.models.mla.assemble
    through assemble_weights);
  - the program's state is one latent cache, [L, S, kv_lora_rank +
    qk_rope_head_dim] bf16 (ChatSession.k_cache; the port has no batched
    MLA path, so a BatchEngine slot has none);
  - the reference is reference/deepseek_v2.py;
  - the work counts follow harness/work.py's rule: attention reads each
    live latent row once (K9) and runs wkv_b's two absorbed products, the
    head is the int8 head at this vocabulary, and each token adds its
    embedding row, the norms, the 64-wide gate and one latent row written
    a layer. latent_attention is K9's part alone (its roofline reader,
    metrics/k9_roofline.decode.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from harness.weights_deepseek_v2 import RawDeepseekV2
from harness.work import Work
from reference.deepseek_v2 import Reference

__all__ = ("Dims", "dims", "build", "state_shapes", "state_of",
           "Reference", "attention", "head", "token_overhead")


@dataclasses.dataclass(frozen=True)
class Dims:
    """A DeepSeek-V2 configuration's shapes, read from its published
    keys."""
    dim: int
    hidden: int              # the leading dense layers' FFN
    n_layers: int
    n_heads: int
    vocab: int
    n_experts: int
    top_k: int
    expert_hidden: int       # a routed expert's FFN
    n_shared: int
    first_dense: int
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_head: int
    norm_eps: float
    rope_theta: float
    rope_scaling: Optional[dict]
    norm_topk_prob: bool
    max_seq_len: int

    @property
    def latent(self) -> int:
        """A cache row's width: the latent, then the rotary key."""
        return self.kv_lora_rank + self.qk_rope


# what the port's DeepSeek-V2 path computes; a configuration that states
# otherwise is refused, not run as something else
_SUPPORTED = {"q_lora_rank": None, "scoring_func": "softmax",
              "topk_method": "greedy", "n_group": 1, "topk_group": 1,
              "moe_layer_freq": 1, "hidden_act": "silu",
              "attention_bias": False, "routed_scaling_factor": 1}


def dims(cfg_file: dict) -> Dims:
    """Dims from a configuration file's Hugging Face keys."""
    cfg = cfg_file
    for k, v in _SUPPORTED.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"{k} = {cfg[k]!r}: the port's DeepSeek-V2 "
                             f"path computes {k} = {v!r}")
    sc = cfg.get("rope_scaling")
    if sc and sc.get("type") != "yarn":
        raise ValueError(f"rope_scaling {sc.get('type')!r}: YaRN only")
    return Dims(
        dim=cfg["hidden_size"], hidden=cfg["intermediate_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], vocab=cfg["vocab_size"],
        n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        expert_hidden=cfg["moe_intermediate_size"],
        n_shared=cfg.get("n_shared_experts") or 0,
        first_dense=cfg["first_k_dense_replace"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope=cfg["qk_nope_head_dim"],
        qk_rope=cfg["qk_rope_head_dim"], v_head=cfg["v_head_dim"],
        norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
        rope_scaling=sc, norm_topk_prob=bool(cfg["norm_topk_prob"]),
        max_seq_len=cfg["max_position_embeddings"])


# ---- the program ----

def port_config(name: str, d: Dims):
    """The port's ModelConfig of a configuration's shapes."""
    from effort_tpu_torch.config import ModelConfig
    return ModelConfig(
        name=name, dim=d.dim, hidden_dim=d.hidden, n_layers=d.n_layers,
        n_heads=d.n_heads, n_kv_heads=d.n_heads, head_dim=d.v_head,
        vocab_size=d.vocab, norm_eps=d.norm_eps, rope_theta=d.rope_theta,
        max_seq_len=d.max_seq_len, n_experts=d.n_experts,
        n_experts_per_tok=d.top_k, kv_lora_rank=d.kv_lora_rank,
        qk_nope_head_dim=d.qk_nope, qk_rope_head_dim=d.qk_rope,
        v_head_dim=d.v_head, moe_hidden_dim=d.expert_hidden,
        n_shared_experts=d.n_shared, first_dense_layers=d.first_dense,
        # renormalised, the top k of the softmax over all are the softmax
        # of the top-k logits
        gate_scoring="topk" if d.norm_topk_prob else "all",
        rope_scaling=dict(d.rope_scaling) if d.rope_scaling else None)


def raw_weights(src: RawDeepseekV2) -> dict:
    """The raw dict the port's assembly takes (models/mla.assemble), each
    matrix a RawWeight whose instances come from src's seeded blocks."""
    from effort_tpu_torch.models.transformer import RawWeight
    d, dev = src.d, src.device

    def lazy(name):
        return RawWeight(
            lambda s, n: torch.stack([src.block(name, s + i)
                                      for i in range(n)]),
            src.n_inst(name), *src.shape(name))

    raw = {n: lazy(n) for n in ("wq", "wkv_a", "wkv_b", "wo", "w1", "w2",
                                "w3", "dense_w1", "dense_w2", "dense_w3",
                                "shared_w1", "shared_w2", "shared_w3")}
    moe = d.n_layers - d.first_dense
    raw.update(
        tok_embeddings=src.embeddings(), output=src.head(),
        ffn_gate=torch.stack([src.gate(m) for m in range(moe)]),
        kv_norm=torch.ones((d.n_layers, d.kv_lora_rank), device=dev),
        attn_norm=torch.ones((d.n_layers, d.dim), device=dev),
        ffn_norm=torch.ones((d.n_layers, d.dim), device=dev),
        norm=torch.ones((d.dim,), device=dev))
    return raw


# Seconds the card is left idle once the weights are built, inside set-up.
# Right after the build, this model's decode ran about 9% slower a token
# (10.1-10.4 against 9.2-9.5 ms) for 4 s to a whole 16 s window in 6 of 9
# tries on an H100, with no clock, temperature, power, throttle or host
# load to show for it; after 5-20 s idle, 4 of 4 ran at the steady rate
# throughout (PERF.md, section 7, item 2).
SETTLE_S = 20.0


def build(name: str, dims: Dims, bucket: dict, seed: int, device):
    """(weights, port ModelConfig, RawDeepseekV2): the port's model of one
    configuration and seed, bucketized on `device` as the configuration's
    `bucket` layout states, wq|wkv_a and every w1|w3 fused, the baked
    calibration relayout, wkv_b in bf16, the int8 head with its exact
    rescore. No dense copies are kept. On the card, the build ends with
    SETTLE_S seconds idle, which set-up counts."""
    from effort_tpu_torch.config import BucketConfig
    from effort_tpu_torch.models.transformer import (assemble_weights,
                                                     quantize_head)
    src = RawDeepseekV2(dims, seed, device)
    cfg = port_config(name, dims)
    bcfg = BucketConfig(bucket_size=bucket["bucket_size"],
                        chunk_rows=bucket["chunk_rows"],
                        probes=bucket["probes"], dtype=bucket["dtype"])
    w = assemble_weights(raw_weights(src), cfg, bcfg, rms_m=src.rms_m,
                         rms_f=src.rms_f, rms_e=src.rms_e, rms_s=src.rms_s,
                         fuse=True)
    w = quantize_head(w)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        time.sleep(SETTLE_S)
    return w, cfg, src


# ---- the program's state ----

def state_shapes(d: Dims, rows: int) -> list:
    """A judged sequence's latent rows: bf16 [L, rows, R + rope]."""
    return [((d.n_layers, rows, d.latent), torch.bfloat16)]


def state_of(owner, slot, start: int, n: int) -> tuple:
    """(latent rows,) of positions start .. start + n - 1 in a
    ChatSession's latent cache (its k_cache). The port serves no batched
    MLA, so a slot has none."""
    if slot is not None:
        raise ValueError("the port has no batched MLA path: no BatchEngine "
                         "slot holds a latent cache")
    return (owner.k_cache[:, start:start + n],)


# ---- work counts (the rule of harness/work.py) ----

def latent_attention(n_live: int, n_keys: int, T: int, d: Dims) -> Work:
    """K9: T queries (H heads of R + rope, f32) over their live latent
    rows, each row (bf16) read once for every head, the outputs (H x R f32)
    written once; 2 H (R + rope + R) operations a live (query, row)
    pair."""
    H, W, R = d.n_heads, d.latent, d.kv_lora_rank
    return Work(bytes=n_keys * W * 2 + T * H * (W + R) * 4,
                flops=2.0 * H * (W + R) * n_live)


def attention(n_live: int, n_keys: int, T: int, d: Dims) -> Work:
    """One layer's attention in absorbed form: K9 (latent_attention), and
    wkv_b's two products (bf16 W_UK and W_UV read once, T queries through
    each)."""
    H, R = d.n_heads, d.kv_lora_rank
    w = latent_attention(n_live, n_keys, T, d)
    w += Work(bytes=H * R * (d.qk_nope + d.v_head) * 2
              + T * H * (d.qk_nope + d.v_head) * 4,
              flops=2.0 * T * H * R * (d.qk_nope + d.v_head))
    return w


def head(d: Dims, T: int = 1) -> Work:
    """The int8 head for T rows: the codes and column scales once."""
    return Work(bytes=d.vocab * d.dim + d.vocab * 4
                + T * (d.dim * 4 + d.vocab * 4),
                flops=2.0 * T * d.vocab * d.dim)


def token_overhead(d: Dims, T: int = 1) -> Work:
    """Embedding rows, norm weights (the latent's too) and the gate of T
    tokens through every layer, and one latent row written a layer."""
    L, E = d.n_layers, d.n_experts
    moe = L - d.first_dense
    return Work(bytes=T * d.dim * 2 + (2 * L + 1) * d.dim * 4
                + L * d.kv_lora_rank * 4 + T * L * d.latent * 2
                + moe * d.dim * E * 2,
                flops=2.0 * T * moe * d.dim * E)
