"""The manifest and the files it names, found by name.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
harness finds everything else from those names:

  <file named by the configuration entry>           sizes and assumptions
  traffic/<mix>.json                                the mix's parameters
  drivers/<driver>.py                               the code a mix names
  metrics/<metric>.py                               one per-layer reader
                        (or metrics/<first part of the name>.py, shared)
  limits/<cell>.json                                the correctness limits

so a later change adds a configuration, a mix, a cell or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


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


def dims_of(cfg: dict) -> Dims:
    """Dims from a configuration file's Hugging Face keys."""
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


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """BENCHMARK.json at the checkout's root, and lookups by name."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = load_json(self.root / "BENCHMARK.json")
        # the benchmark's own folder: the first of its paths
        self.bench = self.root / self.data["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metric entries that
        cell reports: those without a workloads key, and those that name
        the cell."""
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def traffic(self, mix: str) -> dict:
        return load_json(self.bench / "traffic" / f"{mix}.json")

    def limits(self, cell: str) -> dict:
        return load_json(self.bench / "limits" / f"{cell}.json")

    def module(self, kind: str, name: str):
        """<bench>/<kind>/<name>.py as a module (names may hold dots), or
        else the file of the name's first part: one reader serves every
        metric of one quantity (idle_share.py for idle_share.decode and
        idle_share.serve), and a later name.py of its own takes over."""
        path = self.bench / kind / f"{name}.py"
        if not path.is_file():
            path = self.bench / kind / f"{name.split('.')[0]}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} module for {name!r}")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
