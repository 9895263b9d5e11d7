"""Raw weights of a DeepSeek-V2 configuration from the seed, made on the
device: harness/weights.py's recipe, carried over to DeepSeek-V2's matrices.

As there: every block has its own generator, seeded from (seed, matrix,
instance) by weights.seed_of, so a block is the same whichever side (the
program's set-up or the reference) asks for it and in whatever order;
N(0, 0.02^2) entries; a lognormal per-dim rms (sigma 1.2), one fixed draw
(weights.PROFILE_SEED) that each seed permutes, imprinted on the output
columns of every matrix that writes into a space, and on the embedding.
The spaces: the residual (rms_m), the dense FFN's hidden space (rms_f), a
routed expert's (rms_e, one profile for every expert, as Mixtral's experts
share rms_f) and the shared experts' (rms_s). The attention's own spaces
(q, the latent, wkv_b's keys and values) take no profile: the latent passes
an RMS norm, and none of them is an effort product's input.

seed_of names a block by one of weights.NAMES and an instance; a DeepSeek
matrix takes the name of its Mistral counterpart (wkv_a: wk, wkv_b: wv)
and an instance in a range of its own kind (KINDS), so no two blocks share
a generator.
"""

from __future__ import annotations

import torch

from harness.weights import (PROFILE_SEED, RMS_SIGMA, SCALE, _randn,
                             seed_of)

_SPAN = 1 << 24        # instances of one kind
# name -> (the weights.NAMES entry its seed takes, its kind's range)
KINDS = {"wq": ("wq", 0), "wkv_a": ("wk", 0), "wkv_b": ("wv", 0),
         "wo": ("wo", 0),
         "w1": ("w1", 0), "w3": ("w3", 0), "w2": ("w2", 0),
         "dense_w1": ("w1", 1), "dense_w3": ("w3", 1), "dense_w2": ("w2", 1),
         "shared_w1": ("w1", 2), "shared_w3": ("w3", 2),
         "shared_w2": ("w2", 2)}
# the profile of the space each matrix's output columns write into
_COLS = {"wo": "rms_m", "w2": "rms_m", "dense_w2": "rms_m",
         "shared_w2": "rms_m", "w1": "rms_e", "w3": "rms_e",
         "dense_w1": "rms_f", "dense_w3": "rms_f", "shared_w1": "rms_s",
         "shared_w3": "rms_s"}


class RawDeepseekV2:
    """The raw weights of one DeepSeek-V2 configuration (`dims`, the Dims
    of architectures/deepseek_v2.py) for one seed, made block by block on
    `device`. Matrices are [in, out] f32 (Hugging Face's Linear weights
    transposed), in the published column order."""

    def __init__(self, dims, seed: int, device):
        self.d = dims
        self.seed = int(seed)
        self.device = torch.device(device)
        d = dims
        self.rms_m = self._profile("rms_m", 0, d.dim)
        self.rms_f = self._profile("rms_f", 0, d.hidden)
        self.rms_e = self._profile("rms_f", 1, d.expert_hidden)
        self.rms_s = self._profile("rms_f", 2,
                                   d.n_shared * d.expert_hidden)

    def _profile(self, name: str, inst: int, n: int) -> torch.Tensor:
        """The fixed lognormal profile of n dims, in the seed's order."""
        base = torch.exp(_randn((n,), seed_of(PROFILE_SEED, name, inst),
                                self.device) * RMS_SIGMA)
        g = torch.Generator(device=self.device)
        g.manual_seed(seed_of(self.seed, name, inst))
        return base[torch.randperm(n, generator=g, device=self.device)]

    def shape(self, name: str) -> tuple:
        d = self.d
        qk, sh = d.qk_nope + d.qk_rope, d.n_shared * d.expert_hidden
        return {"wq": (d.dim, d.n_heads * qk),
                "wkv_a": (d.dim, d.kv_lora_rank + d.qk_rope),
                "wkv_b": (d.kv_lora_rank, d.n_heads * (d.qk_nope + d.v_head)),
                "wo": (d.n_heads * d.v_head, d.dim),
                "dense_w1": (d.dim, d.hidden), "dense_w3": (d.dim, d.hidden),
                "dense_w2": (d.hidden, d.dim),
                "w1": (d.dim, d.expert_hidden),
                "w3": (d.dim, d.expert_hidden),
                "w2": (d.expert_hidden, d.dim),
                "shared_w1": (d.dim, sh), "shared_w3": (d.dim, sh),
                "shared_w2": (sh, d.dim)}[name]

    def n_inst(self, name: str) -> int:
        d = self.d
        moe = d.n_layers - d.first_dense
        if name.startswith("dense_"):
            return d.first_dense
        if name.startswith("shared_"):
            return moe
        if name in ("w1", "w2", "w3"):
            return moe * d.n_experts
        return d.n_layers

    def block(self, name: str, inst: int) -> torch.Tensor:
        """Matrix `name` of instance inst (a layer; the first_dense layers'
        dense FFN by layer; MoE layer m's shared experts m, its routed
        expert e m * E + e): [in, out] f32."""
        base, kind = KINDS[name]
        w = _randn(self.shape(name), seed_of(self.seed, base,
                                             kind * _SPAN + inst),
                   self.device) * SCALE
        col = _COLS.get(name)
        return w if col is None else w * getattr(self, col)[None, :]

    def embeddings(self) -> torch.Tensor:
        return (_randn((self.d.vocab, self.d.dim),
                       seed_of(self.seed, "tok_embeddings"), self.device)
                * SCALE * self.rms_m[None, :])

    def head(self) -> torch.Tensor:
        """[dim, vocab] f32."""
        return _randn((self.d.dim, self.d.vocab),
                      seed_of(self.seed, "output"), self.device) * SCALE

    def gate(self, m: int) -> torch.Tensor:
        """[dim, E] f32 router of MoE layer m."""
        return _randn((self.d.dim, self.d.n_experts),
                      seed_of(self.seed, "ffn_gate", m), self.device) * SCALE
