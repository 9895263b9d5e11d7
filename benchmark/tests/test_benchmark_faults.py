"""`correct` comes out false when the timed path is broken underneath.

Each case drives a whole run of a tiny cell on the CPU (the harness's look
for a card skipped, everything else as on the card) with a fault planted
in the program in that run's process, and reads the result line:

  - the control: the program with int4 buckets where the configuration
    states int8 (--variant int4), the step that would tempt a later change;
  - a token altered where it is produced: every decode step's logits
    make the worst token the pick (the head of a single step, and of a
    batched step);
  - a step that returns its state unchanged: every decode step writes
    its key and value rows into a copy of the cache, so the cache keeps
    what it held before the step;
  - half of the batch left out: the batched step's second half of the
    slots takes the first half's logits (the serve cell; the chat cells
    step one sequence, and no cell spans chips, so no exchange between
    chips can be left out).

The same runs without a fault come out correct. Each tiny cell compares
what its cell of BENCHMARK.json compares; the limits are set between what
the tiny cells' sound runs and their control read on the CPU (sound: every
gap 0 on the chat cells, on serve a mean gap of at most 0.0023 logits, a
median key/value error of at most 0.030 and a first layer's largest of
at most 0.052; control: mean gaps 0.50-0.69, lower quartiles 0.13-0.45,
key/value errors 0.146-0.152). The cells of BENCHMARK.json take theirs
from runs on the card (PERF.md)."""

import pytest

from support import make_copy, run_cpu

ALTER_HEAD = '''
import effort_tpu_torch.models.transformer as T
def _alter(y):
    y = y.clone()
    i = y.argmin(dim=-1, keepdim=True)
    return y.scatter(-1, i, y.amax(dim=-1, keepdim=True) + 1.0)
_h, _hb = T.head_logits, T.head_logits_batch
T.head_logits = lambda w, h: _alter(_h(w, h))
T.head_logits_batch = lambda w, H: _alter(_hb(w, H))
'''

STATE_UNCHANGED = '''
import effort_tpu_torch.models.session as S
import effort_tpu_torch.serving.batcher as B
_t, _tb = S.forward_token, B.forward_token_batch
S.forward_token = lambda w, cfg, tok, pos, kc, vc, *a, **k: _t(
    w, cfg, tok, pos, kc.clone(), vc.clone(), *a, **k)
B.forward_token_batch = lambda w, cfg, tok, pos, kc, vc, *a, **k: _tb(
    w, cfg, tok, pos, kc.clone(), vc.clone(), *a, **k)
'''

HALF_BATCH = '''
import torch
import effort_tpu_torch.serving.batcher as B
_tb = B.forward_token_batch
def _half(*a, **k):
    y = _tb(*a, **k)
    h = y.shape[0] // 2
    return torch.cat([y[:h], y[:y.shape[0] - h]])
B.forward_token_batch = _half
'''

KV = {"kv_median": 0.07, "kv_first_layer_max": 0.1}
LIMITS = {"tiny.chat": {"mean_gap": 0.1, **KV},
          "tiny.serve": {"mean_gap": 0.1, **KV},
          "tiny-moe.chat": {"q1_gap": 0.08, **KV}}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"), LIMITS)


def _run(copy, cell, seed, extra=(), patch=""):
    out, p = run_cpu(copy, ["--workload", cell, "--seed", str(seed),
                            "--seconds", "2", "--trace", "0", *extra],
                     patch=patch)
    assert out is not None, p.stderr[-3000:]
    lines = p.stderr.strip().splitlines()
    # the numbers compared, each beside its limit, end standard error
    want = list(LIMITS[cell])
    assert [l.split()[1] for l in lines[-len(want):]] == want
    return out


def _failed(out):
    return [k for k, c in out["compared"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.serve",
                                  "tiny-moe.chat"])
def test_sound_runs_are_correct_and_the_control_is_not(copy, cell):
    for seed in (2**31 + 5, 77):
        assert _run(copy, cell, seed)["correct"]
        out = _run(copy, cell, seed, ("--variant", "int4"))
        assert not out["correct"] and _failed(out)


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.serve",
                                  "tiny-moe.chat"])
def test_a_token_altered_where_it_is_produced_is_caught(copy, cell):
    out = _run(copy, cell, 2**31 + 5, patch=ALTER_HEAD)
    assert not out["correct"] and set(_failed(out)) & {"mean_gap",
                                                        "q1_gap"}


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.serve",
                                  "tiny-moe.chat"])
def test_a_step_that_leaves_its_state_unchanged_is_caught(copy, cell):
    out = _run(copy, cell, 2**31 + 5, patch=STATE_UNCHANGED)
    assert not out["correct"] and _failed(out)


def test_half_of_the_batch_left_out_is_caught(copy):
    out = _run(copy, "tiny.serve", 2**31 + 5, patch=HALF_BATCH)
    assert not out["correct"] and "mean_gap" in _failed(out)
