"""The manifest and the files it names, found by name.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
harness finds everything else from those names:

  <file named by the configuration entry>           sizes and assumptions
  architectures/<its model_type>.py                 the model: its shapes,
                        build, cache state, reference and work counts
  traffic/<mix>.json                                the mix's parameters
  drivers/<driver>.py                               the code a mix names
  metrics/<metric>.py                               one per-layer reader
                        (or metrics/<first part of the name>.py, shared)
  limits/<cell>.json                                the correctness limits

so a later change adds a configuration (of an architecture the harness
has, or with a module of a new one), a mix, a cell or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


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

    def _config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.root / self._config_entry(name)["file"])

    def architecture(self, name: str):
        """The module of configuration `name`'s architecture:
        architectures/<model_type>.py, model_type as the configuration's
        file states it. A file that states none, or names a module that
        is not there, fails with the path looked for."""
        model_type = self.config(name).get("model_type")
        if not model_type:
            raise ValueError(
                f"{self._config_entry(name)['file']} states no model_type:"
                f" looked for {self.bench / 'architectures'}/"
                f"<model_type>.py")
        return self.module("architectures", model_type)

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
        tried = list(dict.fromkeys(
            str(self.bench / kind / f"{n}.py")
            for n in (name, name.split(".")[0])))
        path = next((p for p in tried if Path(p).is_file()), None)
        if path is None:
            raise FileNotFoundError(f"no {kind} module for {name!r}: "
                                    f"looked for {' and '.join(tried)}")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        # registered first, as an import would: a dataclass looks its
        # module up while the module runs
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod
