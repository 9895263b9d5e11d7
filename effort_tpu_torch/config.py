"""Configuration dataclasses (the port's own copy; same JSON schema as the
JAX package's config, so one `config.json` serves both packages)."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """Parameters of the bucketized weight format.

      - bucket_size (B): contiguous output-column group whose elements are
        magnitude-sorted; rank k of each bucket forms one "bucket row".
        B = 1 is the row-prefix layout: whole input rows are the selection
        unit and no within-bucket positions exist (kernels/fused_stream).
      - chunk_rows (G): input rows grouped into one streamed block.
      - probes (P): number of sampled (input-dim, weight) pairs used for the
        runtime cutoff quantile.
      - dtype: storage type of bucket values: "bf16", "int8" or "int4"
        (int8/int4 carry per-bucket-row scales; int4 optionally an f32
        outlier table).
      - percent_load: fraction (0..1] of ranks (B >= 2) or row chunks
        (B = 1, calibration-sorted rows) kept at load time.
    """

    bucket_size: int = 4
    chunk_rows: int = 8
    probes: int = 4096
    dtype: str = "bf16"
    percent_load: float = 1.0
    # int4 only: top-|w| fraction kept as an exact f32 table. Off by
    # default: quantile-clipped scales (clip_quantile) give the same
    # quality without the table's scatter-add.
    outlier_frac: float = 0.0
    clip_quantile: float = 0.99  # int4 scale rule: s = q-quantile(|w|)/7

    def __post_init__(self):
        if self.bucket_size not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"bucket_size {self.bucket_size}")
        if self.dtype not in ("bf16", "int8", "int4"):
            raise ValueError(f"dtype {self.dtype}")
        if not 0.0 < self.percent_load <= 1.0:
            raise ValueError(f"percent_load {self.percent_load}")

    @property
    def ranks_loaded(self) -> int:
        """Number of rank slices kept after truncated loading."""
        return max(1, int(round(self.percent_load * self.bucket_size)))


# the fields of DeepSeek-V2's decoder; at their defaults they leave a
# Llama / Mistral / Mixtral config as it was, and its saved JSON holds none
# of them (ModelConfig.as_dict)
_MLA_FIELDS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
               "v_head_dim", "moe_hidden_dim", "n_shared_experts",
               "first_dense_layers", "gate_scoring", "rope_scaling")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Transformer architecture config (Llama/Mistral/Mixtral family, and
    DeepSeek-V2's latent attention and fine-grained experts)."""

    name: str = "mistral-7b"
    dim: int = 4096
    hidden_dim: int = 14336
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    vocab_size: int = 32000
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    max_seq_len: int = 2048
    # Sliding-window attention width (Mistral-7B: 4096). None = full causal.
    sliding_window: Optional[int] = None
    # MoE (Mixtral); n_experts=1 means a dense FFN
    n_experts: int = 1
    n_experts_per_tok: int = 2
    # Per-projection effort floors, e.g. {"wk": 0.45, "wv": 0.45}: the
    # projection's effective effort is max(effort, floor). None/{} =
    # uniform effort.
    effort_floors: Optional[dict] = None
    # Multi-head latent attention (DeepSeek-V2), on when kv_lora_rank > 0:
    # q is qk_nope_head_dim + qk_rope_head_dim wide a head, keys and values
    # come from one kv_lora_rank-wide latent row and one shared
    # qk_rope_head_dim-wide rotary key a position (the cache holds those),
    # values are v_head_dim wide; head_dim and n_kv_heads are then unused
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # width of a routed expert (0: hidden_dim, Mixtral's), shared experts
    # (n_shared_experts of that width act as one FFN n times as wide, added
    # for every token), and leading dense layers (hidden_dim wide) before
    # the MoE layers
    moe_hidden_dim: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    # the gates: "topk", the softmax of the top-k logits (Mixtral), or
    # "all", the softmax over every logit and then the top k, not
    # renormalised (DeepSeek-V2; renormalised, those gates equal "topk"'s)
    gate_scoring: str = "topk"
    # YaRN (DeepSeek-V2's rope_scaling dict: factor,
    # original_max_position_embeddings, beta_fast, beta_slow, mscale,
    # mscale_all_dim); None = plain RoPE
    rope_scaling: Optional[dict] = None

    def __post_init__(self):
        if self.gate_scoring not in ("topk", "all"):
            raise ValueError(f"gate_scoring {self.gate_scoring!r}")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        """MLA: a query head's width, its "nope" part then its rotary."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """MLA: a cache row's width, the latent then the rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def expert_dim(self) -> int:
        """A routed expert's hidden width."""
        return self.moe_hidden_dim or self.hidden_dim

    def moe_layer(self, l: int) -> int:
        """The index of layer l among the MoE layers (its gate, its shared
        expert, and its routed experts' instances from moe_layer(l) *
        n_experts)."""
        return l - self.first_dense_layers

    @property
    def kv_repeats(self) -> int:
        return self.n_heads // self.n_kv_heads

    def as_dict(self) -> dict:
        """The fields as a dict, without DeepSeek-V2's fields at their
        defaults: a Llama / Mistral / Mixtral config saves what it saved
        before they existed (the JAX package's schema)."""
        d = dataclasses.asdict(self)
        for f in dataclasses.fields(self):
            if f.name in _MLA_FIELDS and d[f.name] == f.default:
                del d[f.name]
        return d

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), indent=2)

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        return ModelConfig(**json.loads(s))


def mistral_7b(**kw) -> ModelConfig:
    # sliding_window=4096 matches the HF checkpoint config; it only
    # changes anything when max_seq_len is raised past the window.
    return dataclasses.replace(
        ModelConfig(name="mistral-7b", sliding_window=4096), **kw)


def llama2_7b(**kw) -> ModelConfig:
    """Llama-2-7B: Mistral-7B's decoder with MHA (32 KV heads), 11008 FFN
    hidden, 4096 context, theta 1e4."""
    return dataclasses.replace(
        ModelConfig(name="llama2-7b", hidden_dim=11008, n_kv_heads=32,
                    rope_theta=1e4, max_seq_len=4096, vocab_size=32000),
        **kw,
    )


def llama3_8b(**kw) -> ModelConfig:
    """Llama-3-8B: Mistral-shaped decoder (GQA 32/8, 14336 FFN) with the
    128k-token vocabulary and rope_theta 5e5."""
    return dataclasses.replace(
        ModelConfig(name="llama3-8b", vocab_size=128256, rope_theta=5e5,
                    max_seq_len=4096),
        **kw,
    )


def mixtral_8x7b(**kw) -> ModelConfig:
    return dataclasses.replace(
        ModelConfig(name="mixtral-8x7b", n_experts=8, n_experts_per_tok=2,
                    rope_theta=1e6),
        **kw,
    )


def deepseek_v2_lite(**kw) -> ModelConfig:
    """DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json;
    DeepSeek-V2, arXiv:2405.04434 2.1-2.2): 27 layers at hidden 2048; MLA
    with 16 heads, no q-LoRA, latent 512, q/k heads 128 + 64 rotary, v
    128; YaRN (factor 40 from 4096 positions); layer 0 a dense FFN of
    10944, then 64 routed experts of 1408 a layer, top 6 of a softmax over
    all 64, not renormalised, plus 2 shared experts. max_seq_len is the
    cache's length, 4096 (the YaRN base context), not the published
    163840."""
    return dataclasses.replace(
        ModelConfig(
            name="deepseek-v2-lite", dim=2048, hidden_dim=10944,
            n_layers=27, n_heads=16, n_kv_heads=16, head_dim=128,
            vocab_size=102400, norm_eps=1e-6, rope_theta=10000.0,
            max_seq_len=4096, n_experts=64, n_experts_per_tok=6,
            kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128, moe_hidden_dim=1408, n_shared_experts=2,
            first_dense_layers=1, gate_scoring="all",
            rope_scaling={"type": "yarn", "factor": 40.0,
                          "original_max_position_embeddings": 4096,
                          "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                          "mscale_all_dim": 0.707}),
        **kw,
    )


def tiny_test_model(**kw) -> ModelConfig:
    """A reduced config for tests: two narrow layers."""
    return dataclasses.replace(
        ModelConfig(
            name="tiny",
            dim=256,
            hidden_dim=512,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=64,
            vocab_size=512,
            max_seq_len=128,
        ),
        **kw,
    )
