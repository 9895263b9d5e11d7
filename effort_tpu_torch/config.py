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


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Transformer architecture config (Llama/Mistral/Mixtral family)."""

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

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    @property
    def kv_repeats(self) -> int:
        return self.n_heads // self.n_kv_heads

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

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
