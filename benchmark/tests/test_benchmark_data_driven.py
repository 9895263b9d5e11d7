"""A configuration, an architecture, a traffic mix, a per-layer metric and
a cell are added by files and entries alone: in a copy of the benchmark,
new files and a new cell entry resolve, parse, generate and load with no
edit to any file that was there. The run itself still fails without a
card; on the CPU (the look for a card skipped) a cell of a new
architecture runs end to end through that architecture's module alone."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from support import BENCH, DATA, make_copy, run_cpu

NEW_METRIC = '''
def read(r):
    return None if not r.ops else float(len(r.ops))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_resolve_without_edits(tmp_path):
    make_copy(tmp_path)
    bench = tmp_path / BENCH.name
    before = _digests(bench)
    (bench / "metrics" / "ops_count.decode.py").write_text(NEW_METRIC)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["per_layer"].append({
        "name": "ops_count.decode", "unit": "ops", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "decode_ms_per_token", "workloads": ["tiny.chat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digests(bench)
    changed = [p for p in before if before[p] != after.get(p)]
    assert not changed, changed

    sys.path.insert(0, str(bench))
    try:
        from harness import spec, traffic
        m = spec.Manifest(tmp_path)
        assert m.bench == bench
        cell = m.cell("tiny.chat")
        arch = m.architecture(cell["config"])
        assert arch.__file__ == str(bench / "architectures" / "mistral.py")
        dims = arch.dims(m.config(cell["config"]))
        assert (dims.dim, dims.n_layers, dims.vocab) == (256, 2, 512)
        mix = m.traffic(cell["traffic"])
        plan = traffic.Plan(mix, 11, dims.vocab, dims.max_seq_len)
        assert plan.items and plan.ids(4)
        assert m.module("drivers", mix["driver"]).Driver
        names = [x["name"] for x in m.metrics("tiny.chat", "per_layer")]
        assert "ops_count.decode" in names
        assert m.module("metrics", "ops_count.decode").read
        assert m.limits("tiny.chat")["median_gap"]["limit"] > 0
    finally:
        sys.path.remove(str(bench))

    # without a card the run exits non-zero and prints no result
    p = subprocess.run([sys.executable, str(bench / "run.py"), "--workload",
                        "tiny.chat", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path))
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_a_metric_without_a_reader_of_its_own_takes_the_shared_one():
    """idle_share.decode and idle_share.serve read with idle_share.py; a
    new name of the same quantity needs no file, a file of its own name
    takes over, and a name with neither is refused."""
    sys.path.insert(0, str(BENCH))
    try:
        from harness import spec
        from support import REPO
        m = spec.Manifest(REPO)
        shared = m.module("metrics", "idle_share.decode")
        assert shared.__file__.endswith("idle_share.py")
        assert m.module("metrics", "idle_share.train").read
        own = m.module("metrics", "k1_roofline.decode")
        assert own.__file__.endswith("k1_roofline.decode.py")
        try:
            m.module("metrics", "no_such_reader.decode")
        except FileNotFoundError:
            pass
        else:
            raise AssertionError("a metric with no reader resolved")
    finally:
        sys.path.remove(str(BENCH))


# an architecture of its own name: Mistral's, each name wrapped so that
# every call says where it was taken from
ALIAS = """
import sys

from architectures import mistral as _base


def _say(name):
    print(f"tiny-alias: {name}", file=sys.stderr, flush=True)


def _counted(name):
    fn = getattr(_base, name)

    def call(*a, **k):
        _say(name)
        return fn(*a, **k)
    return call


for _name in ("dims", "build", "state_shapes", "state_of", "attention",
              "head", "token_overhead"):
    globals()[_name] = _counted(_name)


class Reference(_base.Reference):
    def __init__(self, *a, **k):
        _say("Reference")
        super().__init__(*a, **k)
"""
ALIAS_NAMES = {"dims", "build", "state_shapes", "state_of", "Reference",
               "attention", "head", "token_overhead"}


def _add_config(root, name: str, model_type, cell: str) -> None:
    """Configuration `name` (tiny's sizes, the model_type given, or none)
    and a chat cell of it, as files and entries."""
    bench = root / BENCH.name
    cfg = json.loads((DATA / "tiny.json").read_text())
    cfg["name"] = name
    cfg.pop("model_type")
    if model_type is not None:
        cfg["model_type"] = model_type
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / "tiny.chat.json",
                bench / "limits" / f"{cell}.json")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": name, "source": "tests", "reduced": [],
                           "file": f"{BENCH.name}/configs/{name}.json",
                           "why": "tests"})
    man["workloads"].append({"name": cell, "config": name,
                             "traffic": "tiny-chat", "chips": 1,
                             "why": "tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "tiny.chat" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def test_a_new_architecture_is_a_module_and_files(tmp_path):
    """architectures/tiny-alias.py, a configuration whose model_type names
    it, and a cell: nothing that was there changes, and a traced CPU run
    of the cell takes the shapes, the build, the state, the reference and
    the work counts from that module."""
    make_copy(tmp_path)
    bench = tmp_path / BENCH.name
    before = _digests(bench)
    (bench / "architectures" / "tiny-alias.py").write_text(ALIAS)
    _add_config(tmp_path, "tiny-alias", "tiny-alias", "tiny-alias.chat")
    after = _digests(bench)
    assert not [p for p in before if before[p] != after.get(p)]

    out, p = run_cpu(tmp_path, ["--workload", "tiny-alias.chat", "--seed",
                                str(2**31 + 21), "--seconds", "1",
                                "--trace", "1"])
    assert out is not None, p.stderr[-3000:]
    assert out["correct"] and out["attempted"] > 0
    assert "step_mfu.decode" in out["metrics"]
    said = {l.split(": ", 1)[1] for l in p.stderr.splitlines()
            if l.startswith("tiny-alias: ")}
    assert said == ALIAS_NAMES, said


@pytest.mark.parametrize("model_type,looked_for", [
    (None, "architectures/<model_type>.py"),
    ("no-such-decoder", "architectures/no-such-decoder.py")])
def test_a_configuration_without_its_architecture_fails_before_setup(
        tmp_path, model_type, looked_for):
    """No silent default: a configuration that states no model_type, or
    one with no module, fails before set-up, naming the path looked
    for."""
    make_copy(tmp_path)
    _add_config(tmp_path, "tiny-untyped", model_type, "tiny-untyped.chat")
    built = "import run\nrun.Run.build = lambda self: print('BUILT')\n"
    out, p = run_cpu(tmp_path, ["--workload", "tiny-untyped.chat",
                                "--seed", "5", "--seconds", "1",
                                "--trace", "0"], patch=built)
    assert out is None and p.returncode != 0
    assert "BUILT" not in p.stdout
    assert str(tmp_path / BENCH.name / looked_for) in p.stderr, \
        p.stderr[-2000:]
