"""The per-layer metrics that read the program's own spans (batcher.*,
session.*: effort_tpu_torch/utils/profiling.py), end to end on the tiny
cells on the CPU: a traced run prints each of its cell's, an untraced run
none, and no span of the program takes a name the benchmark's own spans
use (a program span named `step` would change what k2_roofline.serve
matches)."""

import json

import pytest

from support import make_copy, run_cpu

SERVE = ("queue_wait_ms.serve", "idle_admit.serve", "idle_step.serve",
         "idle_callback.serve", "slots_per_step.serve", "kv_live.serve")
CHAT = ("kv_live.decode", "idle_turn.decode")
BENCH_NAMES = {"window", "turn", "admit", "step"}

# the names of every span the program logged, printed as the run's
# process ends
NAMES_AT_EXIT = '''
import atexit, json
from effort_tpu_torch.utils import profiling
atexit.register(lambda: print("SPANS " + json.dumps(
    sorted({s.name for s in profiling.recorded()}))))
'''


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"))


def _run(copy, cell, trace):
    out, p = run_cpu(copy, ["--workload", cell, "--seed", str(2**31 + 9),
                            "--seconds", "1", "--trace", str(trace)],
                     patch=NAMES_AT_EXIT)
    assert out is not None, p.stderr[-3000:]
    names = [json.loads(l[len("SPANS "):]) for l in p.stdout.splitlines()
             if l.startswith("SPANS ")]
    return out, names[0], p.stderr


@pytest.mark.parametrize("cell,new,program", [
    ("tiny.serve", SERVE, {"batcher.tick", "batcher.queued",
                           "batcher.admit", "batcher.admit.launch",
                           "batcher.admit.read", "batcher.step",
                           "batcher.step.launch", "batcher.step.read",
                           "batcher.callback"}),
    ("tiny.chat", CHAT, {"session.turn", "session.launch",
                         "session.read"})])
def test_traced_runs_print_the_program_span_metrics(copy, cell, new,
                                                    program):
    out, names, err = _run(copy, cell, 1)
    for m in new:
        assert m in out["metrics"], (m, err[-2000:])
        assert out["metrics"][m]["value"] >= 0
    # kernel readers read nothing here (no card, no kernel names)
    silent = [l for l in err.splitlines() if "read nothing" in l]
    assert not any(m in l for m in new for l in silent), silent
    assert program <= set(names), names
    assert not BENCH_NAMES & set(names)
    # the idle gaps inside the program carry its span names
    labels = {g[0] for g in out["breakdown"]["idle_gaps"]}
    assert labels & program, labels
    if cell == "tiny.serve":
        v = {m: out["metrics"][m]["value"] for m in new}
        assert 0 < v["kv_live.serve"] <= 100
        assert 1 <= v["slots_per_step.serve"] <= 4
        # the three idle shares lie inside the window's whole idle share
        assert (v["idle_admit.serve"] + v["idle_step.serve"]
                + v["idle_callback.serve"]
                <= out["metrics"]["idle_share.serve"]["value"] + 1e-6)
    else:
        assert (out["metrics"]["idle_turn.decode"]["value"]
                <= out["metrics"]["idle_share.decode"]["value"] + 1e-6)


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.chat"])
def test_untraced_runs_print_none_and_record_no_span(copy, cell):
    out, names, _ = _run(copy, cell, 0)
    assert not set(SERVE + CHAT) & set(out["metrics"])
    assert names == []
