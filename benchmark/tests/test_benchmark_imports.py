"""What the benchmark loads: no JAX and nothing of the JAX package, by
whole top-level module name (the port's name begins with the JAX
package's), and references that load nothing of the program."""

import json
import subprocess
import sys

from support import BENCH, REPO, make_copy, run_cpu

FORBIDDEN = {"jax", "jaxlib", "flax", "effort_tpu"}

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {repo!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    code = PROBE.format(bench=str(BENCH), repo=str(REPO), imports=imports)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(REPO))
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_run_metrics_reference_and_port_load_no_jax():
    mods = _top_level("""
import run
run._paths()
from harness import spec, readings, trace, traffic, weights, work
from pathlib import Path
man = spec.Manifest(Path({repo!r}))
for c in man.data["configs"]:
    man.architecture(c["name"])
for m in man.data["per_layer"]:
    man.module("metrics", m["name"])
for mix in {{c["traffic"] for c in man.data["workloads"]}}:
    man.module("drivers", man.traffic(mix)["driver"])
import effort_tpu_torch.models.session, effort_tpu_torch.serving.batcher
""".format(repo=str(REPO)))
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "effort_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    """Each configuration's reference, from the module its architecture
    takes it from, loads nothing of the program or of the harness."""
    from harness import spec
    man = spec.Manifest(REPO)
    names = sorted({man.architecture(c["name"]).Reference.__module__
                    for c in man.data["configs"]})
    assert names
    mods = _top_level(f"import importlib\nfor n in {names!r}:\n"
                      f"    importlib.import_module(n)")
    assert not mods & (FORBIDDEN | {"effort_tpu_torch", "harness"})


STUB_READER = """
import sys, types
sys.modules.setdefault("jax", types.ModuleType("jax"))


def read(r):
    return 1.0
"""


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The look for forbidden modules comes after the reference and every
    reader have run: a traced run whose metric reader loads a module
    named jax prints no result and names it; the same run without that
    reader prints one."""
    make_copy(tmp_path)
    argv = ["--workload", "tiny.chat", "--seed", str(2**31 + 9),
            "--seconds", "1", "--trace", "1"]
    out, p = run_cpu(tmp_path, argv)
    assert out is not None, p.stderr[-3000:]
    assert "idle_share.decode" in out["metrics"]
    (tmp_path / BENCH.name / "metrics" / "loads_jax.decode.py").write_text(
        STUB_READER)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["per_layer"].append({
        "name": "loads_jax.decode", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "decode_ms_per_token", "workloads": ["tiny.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    out, p = run_cpu(tmp_path, argv)
    assert out is None
    assert "forbidden modules loaded: ['jax']" in p.stderr, \
        p.stderr[-3000:]
