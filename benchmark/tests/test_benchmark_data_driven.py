"""A configuration, a traffic mix, a per-layer metric and a cell are added
by files and entries alone: in a copy of the benchmark, new files and a
new cell entry resolve, parse, generate and load with no edit to any file
that was there. The run itself still fails without a card."""

import hashlib
import json
import subprocess
import sys

from support import BENCH, make_copy

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
        dims = spec.dims_of(m.config(cell["config"]))
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
