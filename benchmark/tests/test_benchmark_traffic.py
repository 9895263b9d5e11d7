"""The traffic generator: lengths from the seed, in their ranges, the
same set for every seed, and sessions that fit the context."""

import json

import numpy as np
import pytest

from support import BENCH
from harness import traffic

MIXES = {m: json.loads((BENCH / "traffic" / f"{m}.json").read_text())
         for m in ("chat", "serve")}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_plan_is_reproducible_from_the_seed(mix):
    a = traffic.Plan(MIXES[mix], 2**31 + 17, 32000, 2048)
    b = traffic.Plan(MIXES[mix], 2**31 + 17, 32000, 2048)
    c = traffic.Plan(MIXES[mix], 5, 32000, 2048)
    assert a.items == b.items and a.ids(64) == b.ids(64)
    assert a.items != c.items
    # the same set of sizes in another order
    assert sorted(map(str, a.items)) == sorted(map(str, c.items))
    ids = c.ids(10000)
    assert min(ids) >= MIXES[mix]["id_low"] and max(ids) < 32000


def test_chat_lengths_in_range_and_sessions_fit():
    mix = MIXES["chat"]
    for conv in traffic.sessions(mix, 2048):
        assert conv, "every conversation holds a turn"
        pos = 0
        for i, (p, r) in enumerate(conv):
            spec = mix["first_prompt"] if i == 0 else mix["later_prompt"]
            assert spec["low"] <= p <= spec["high"]
            assert mix["reply"]["low"] <= r <= mix["reply"]["high"]
            # the session's own rule: pos + padded prompt + reply <= 2048
            assert pos + traffic.padded(p, mix["pad_to"]) + r <= 2048
            pos += p + r


def test_serve_lengths_in_range():
    mix = MIXES["serve"]
    reqs = traffic.requests(mix, 2048)
    assert len(reqs) == mix["block"]
    for p, r in reqs:
        assert mix["prompt"]["low"] <= p <= mix["prompt"]["high"]
        assert mix["reply"]["low"] <= r <= mix["reply"]["high"]
        assert traffic.padded(p, mix["pad_to"]) + r <= 2048
    for k, i in (("prompt", 0), ("reply", 1)):
        med = np.median([x[i] for x in reqs])
        assert 0.9 * mix[k]["median"] <= med <= 1.1 * mix[k]["median"]
    plan = traffic.Plan(mix, 9, 32000, 2048)
    assert len(plan.items) == mix["block"] * mix["repeats"]
    # every block of the plan holds the same sizes
    b = mix["block"]
    for i in range(0, len(plan.items), b):
        assert sorted(plan.items[i:i + b]) == sorted(reqs)


def test_quartiles_report():
    q = traffic.quartiles([1, 2, 3, 4, 5])
    assert q == {"n": 5, "min": 1, "q1": 2.0, "median": 3.0, "q3": 4.0,
                 "max": 5}
