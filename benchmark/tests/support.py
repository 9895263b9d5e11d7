"""Helpers of the benchmark's CPU tests: a copy of the benchmark with a
tiny configuration and tiny mixes added as files and entries, and a run
of one of its cells on the CPU in a subprocess (the harness's look for a
card skipped, everything else as on the card)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"

TINY_CELLS = (("tiny.chat", "tiny", "tiny-chat"),
              ("tiny.serve", "tiny", "tiny-serve"),
              ("tiny-moe.chat", "tiny-moe", "tiny-chat"))


def make_copy(dest: Path, limits: dict = None) -> Path:
    """BENCHMARK.json and the benchmark's folder under dest, with the tiny
    configurations, mixes, cells and limits added (no file edited).
    limits: {cell: {number: limit}}; a cell left out compares its median
    gap and key/value error with limits no run reaches."""
    dest = Path(dest)
    shutil.copytree(BENCH, dest / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("tiny", "tiny-moe"):
        shutil.copy(DATA / f"{name}.json",
                    dest / BENCH.name / "configs" / f"{name}.json")
        man["configs"].append({
            "name": name, "source": "tests", "reduced": [],
            "file": f"{BENCH.name}/configs/{name}.json", "why": "tests"})
    for mix in ("tiny-chat", "tiny-serve"):
        shutil.copy(DATA / f"{mix}.json",
                    dest / BENCH.name / "traffic" / f"{mix}.json")
    for cell, cfg, mix in TINY_CELLS:
        man["workloads"].append({"name": cell, "config": cfg,
                                 "traffic": mix, "chips": 1, "why": "tests"})
        (dest / BENCH.name / "limits" / f"{cell}.json").write_text(
            json.dumps({k: {"limit": v} for k, v in (limits or {}).get(
                cell, {"median_gap": 1e9, "kv_median": 1e9}).items()}))
        for m in man["end_to_end"] + man["per_layer"]:
            src = "mistral-7b.serve" if "serve" in cell else \
                "mistral-7b.chat"
            if src in m.get("workloads", []):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    # peaks for the host's operators, which stand in for the card's here
    peaks = dest / BENCH.name / "peaks.json"
    table = json.loads(peaks.read_text())
    table["cpu"] = {"source": "tests", "bytes_per_s": 1e11,
                    "flops_per_s": 1e12}
    peaks.write_text(json.dumps(table))
    return dest


RUNNER = """
import json, sys
sys.path.insert(0, {bench!r})
import run
run._paths()
sys.path.append({repo!r})
{patch}
out = run.run_cell(run.parse({argv!r}), run.ROOT, "cpu")
print("RESULT " + json.dumps(out))
"""


def run_cpu(copy: Path, argv: list, patch: str = "",
            timeout: float = 600) -> tuple:
    """(result dict or None, completed process) of one run of a cell of
    the copy on the CPU. patch: code run before the cell (a fault planted
    in the program, in this process only)."""
    code = RUNNER.format(bench=str(Path(copy) / BENCH.name),
                         repo=str(REPO), argv=list(argv), patch=patch)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=str(copy))
    out = None
    for line in p.stdout.splitlines():
        if line.startswith("RESULT "):
            out = json.loads(line[len("RESULT "):])
    return out, p
