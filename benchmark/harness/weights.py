"""Raw weights from the seed, made on the device.

Both sides take their weights from here: the program's set-up bucketizes
them (its own assembly), and the reference rebuilds each matrix from the
same raw blocks, a layer at a time. Every block has its own generator,
seeded from (seed, matrix, instance), so a block is the same whichever
side asks for it and in whatever order; nothing is read from disk.

The recipe is the usual one for a calibrated random model: N(0, 0.02^2)
entries, and a lognormal per-dim rms (sigma 1.2) for the residual space
and for each FFN hidden space, imprinted on the output columns of every
matrix that writes into that space (and on the embedding), so that
activations have the persistent outlier dims that row selection keys on.
The rms profile is one fixed draw (PROFILE_SEED) whose dims the run's
seed permutes: every seed gets the same set of per-dim magnitudes, and
so about the same selections and the same work, on other weights.
"""

from __future__ import annotations

import torch

SCALE = 0.02
RMS_SIGMA = 1.2
PROFILE_SEED = 20250601
_MASK = (1 << 64) - 1
NAMES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "tok_embeddings",
         "output", "ffn_gate", "rms_m", "rms_f")


def seed_of(seed: int, name: str, inst: int = 0) -> int:
    """A 63-bit generator seed for one block (splitmix64 of the parts)."""
    x = 0
    for part in (int(seed), NAMES.index(name), int(inst)):
        x = (x + part + 0x9E3779B97F4A7C15) & _MASK
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        x = z ^ (z >> 31)
    return x >> 1


def _randn(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


class RawModel:
    """The raw weights of one model configuration (`dims` from
    harness.spec.Dims) for one seed, made block by block on `device`."""

    def __init__(self, dims, seed: int, device):
        self.d = dims
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rms_m = self._profile("rms_m", dims.dim)
        self.rms_f = self._profile("rms_f", dims.hidden)

    def _profile(self, name: str, n: int) -> torch.Tensor:
        """The fixed lognormal profile of n dims, in the seed's order."""
        base = torch.exp(_randn((n,), seed_of(PROFILE_SEED, name),
                                self.device) * RMS_SIGMA)
        g = torch.Generator(device=self.device)
        g.manual_seed(seed_of(self.seed, name))
        return base[torch.randperm(n, generator=g, device=self.device)]

    def shape(self, name: str) -> tuple:
        d = self.d
        q, kv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
        return {"wq": (d.dim, q), "wk": (d.dim, kv), "wv": (d.dim, kv),
                "wo": (q, d.dim), "w1": (d.dim, d.hidden),
                "w3": (d.dim, d.hidden), "w2": (d.hidden, d.dim)}[name]

    def n_inst(self, name: str) -> int:
        d = self.d
        return d.n_layers * (d.n_experts if name in ("w1", "w2", "w3")
                             else 1)

    def block(self, name: str, inst: int) -> torch.Tensor:
        """Matrix `name` of instance inst (a layer; layer * E + expert for
        an expert's matrix): [in, out] f32, transposed (rows = inputs)."""
        w = _randn(self.shape(name), seed_of(self.seed, name, inst),
                   self.device) * SCALE
        col = {"wo": self.rms_m, "w2": self.rms_m, "w1": self.rms_f,
               "w3": self.rms_f}.get(name)
        return w if col is None else w * col[None, :]

    def embeddings(self) -> torch.Tensor:
        return (_randn((self.d.vocab, self.d.dim),
                       seed_of(self.seed, "tok_embeddings"), self.device)
                * SCALE * self.rms_m[None, :])

    def head(self) -> torch.Tensor:
        """[dim, vocab] f32."""
        return _randn((self.d.dim, self.d.vocab),
                      seed_of(self.seed, "output"), self.device) * SCALE

    def gate(self, layer: int) -> torch.Tensor:
        """[dim, E] f32 router of one layer."""
        return _randn((self.d.dim, self.d.n_experts),
                      seed_of(self.seed, "ffn_gate", layer),
                      self.device) * SCALE
