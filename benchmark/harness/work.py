"""The yardstick's arithmetic: what the inputs need, in bytes and
operations, and the least time the card could take for it.

Counts follow one rule: each input byte read once and each output byte
written once, whatever a kernel reads again; where the work depends on
the data (the streamed prefix of an effort product), the count is what
the reference selection finds these inputs need, never what the program
reports. Peaks come from peaks.json beside this package, by card name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

_PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def peaks(card: str) -> dict:
    """{"bytes_per_s", "flops_per_s"} of a card by its torch name."""
    with open(_PEAKS) as f:
        table = json.load(f)
    if card not in table:
        raise KeyError(f"no peaks for {card!r} in {_PEAKS.name}")
    return table[card]


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    flops: float = 0.0

    def __iadd__(self, o: "Work") -> "Work":
        self.bytes += o.bytes
        self.flops += o.flops
        return self

    def least_s(self, pk: dict) -> float:
        """The larger of bytes / peak bandwidth and operations / peak
        bf16 rate."""
        return max(self.bytes / pk["bytes_per_s"],
                   self.flops / pk["flops_per_s"])


def effort_product(in_dim: int, out_dim: int, rows: int, probes: int,
                   T: int = 1, code_bytes: float = 1.0) -> Work:
    """One effort product (K1 at T = 1, K2 over T vectors sharing one
    streamed prefix of `rows` rows): the prefix of int8 codes once, the T
    inputs, the per-row stats and scales and the probes once, the T
    outputs written once; 2 operations per streamed weight per vector."""
    return Work(bytes=rows * out_dim * code_bytes + in_dim * 4 * 2
                + T * in_dim * 4 + probes * 4 + T * out_dim * 4,
                flops=2.0 * T * rows * out_dim)


def attention(n_live: int, n_keys: int, T: int, dims) -> Work:
    """T queries over their live keys: each live key and value (bf16)
    read once, the queries and outputs (f32) once; 4 H D operations per
    live (query, key) pair."""
    H, KV, D = dims.n_heads, dims.n_kv_heads, dims.head_dim
    return Work(bytes=2 * n_keys * KV * D * 2 + 2 * T * H * D * 4,
                flops=4.0 * H * D * n_live)


def head(dims, T: int = 1) -> Work:
    """The int8 head for T rows: the codes and column scales once."""
    return Work(bytes=dims.vocab * dims.dim + dims.vocab * 4
                + T * (dims.dim * 4 + dims.vocab * 4),
                flops=2.0 * T * dims.vocab * dims.dim)


def token_overhead(dims, T: int = 1) -> Work:
    """Embedding rows, norm weights and router of T tokens through every
    layer, and the new key and value rows written."""
    L, E = dims.n_layers, dims.n_experts
    w = Work(bytes=T * dims.dim * 2 + (2 * L + 1) * dims.dim * 4
             + T * L * 2 * dims.n_kv_heads * dims.head_dim * 2)
    if E > 1:
        w += Work(bytes=L * dims.dim * E * 2,
                  flops=2.0 * T * L * dims.dim * E)
    return w
