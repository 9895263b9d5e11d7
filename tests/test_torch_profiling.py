"""The port's profiling hooks (utils/profiling.py): JAX's
tests/test_profiling.py (the compiler dump, annotate) on the port, trace
and warn_of_sync, and the program's spans: off, annotate reads no clock
and calls no record_function; on, each span is in the trace and in the
log, with the same nesting; mark; the log's bound. On the CPU the trace
records the host; sass_dump (the JAX package's hlo_dump) needs the card
and nvcc's cuobjdump, so on the CPU it raises, and the card tests dump
K1's SASS and set the sync debug mode."""

import json
import os
import types

import pytest
import torch

from effort_tpu_torch.utils import profiling
from effort_tpu_torch.utils.profiling import (annotate, mark, recorded,
                                              recording, sass_dump, trace,
                                              warn_of_sync)


@pytest.fixture
def log(monkeypatch):
    """A fresh, empty span log for the test (the process's is left as it
    was)."""
    monkeypatch.setattr(profiling, "_LOG", profiling._Log())
    return profiling._LOG


def test_sass_dump_needs_a_card(tmp_path):
    """Without a card (and nvcc's build) there is nothing compiled to
    dump: sass_dump raises and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sass_dump("mxu_matvec", dump_dir=str(tmp_path))
    assert not os.listdir(tmp_path)


def test_annotate():
    with annotate("test-span"):
        torch.zeros(4) + 1


def test_annotate_off_reads_no_clock_and_calls_nothing(log, monkeypatch):
    """With no profiler session and no recording(), annotate is one flag
    check: the shared null context, no record_function, no clock read,
    nothing logged; mark logs nothing either."""
    def boom(*a, **k):
        raise AssertionError("called while spans are off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=boom))
    with annotate("off", rid=3, n=1) as span:
        span["n"] = 2
        assert not span
    assert annotate("a") is annotate("b", rid=1, n=2)
    mark("off.mark", 1.0, 2.0, rid=3)
    assert recorded() == [] and log.added == 0


def test_spans_in_the_trace_and_the_log(log, tmp_path):
    """Under trace(), each span is a trace annotation and a log entry:
    the same names, as many, nested alike (the log's parent against the
    trace's enclosing annotation); attributes set at entry and before
    exit are kept."""
    with trace(str(tmp_path)):
        with annotate("outer", rid=7, a=1) as span:
            for i in range(3):
                with annotate("inner", rid=i):
                    with annotate("leaf"):
                        torch.ones(8).sum()
            span["b"] = 2
        with annotate("after"):
            pass
    with annotate("untraced"):
        pass
    got = recorded()
    names = ["outer"] + ["inner", "leaf"] * 3 + ["after"]
    assert [s.name for s in got] == names
    assert got[0].parent is None and got[-1].parent is None
    assert [s.parent for s in got[1:7]] == [0, 1, 0, 3, 0, 5]
    assert got[0].rid == 7 and got[0].attrs == {"a": 1, "b": 2}
    assert [s.rid for s in got[1:7:2]] == [0, 1, 2]
    assert all(s.t0 <= s.t1 for s in got)
    (f,) = os.listdir(tmp_path)
    with open(tmp_path / f) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e.get("name") in set(names)]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in events] == names

    def parent(i):
        e = events[i]
        inside = [j for j in range(len(events)) if j != i
                  and events[j]["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= events[j]["ts"]
                  + events[j]["dur"]]
        return max(inside, key=lambda j: events[j]["ts"]) if inside \
            else None
    assert [parent(i) for i in range(len(events))] == \
        [s.parent for s in got]


def test_mark_records_the_given_interval(log):
    """mark logs (t0, t1) as given, under the span open around it."""
    with recording():
        with annotate("tick"):
            mark("queued", 1.5, 2.25, rid=4, n=3)
    tick, queued = recorded()
    assert tick.name == "tick" and tick.parent is None
    assert queued == profiling.SpanRecord("queued", 1.5, 2.25, 0, 4,
                                          {"n": 3})


def test_the_log_drops_its_oldest_and_counts_them(log, monkeypatch):
    """At its bound the log drops the oldest spans first, counts them in
    dropped(), and a span whose parent was dropped names none; clear()
    empties it."""
    monkeypatch.setattr(profiling, "_LOG", profiling._Log(maxlen=3))
    with recording():
        with annotate("parent"):
            for i in range(4):
                with annotate("child", rid=i):
                    pass
    got = recorded()
    assert [(s.name, s.rid) for s in got] == [("child", 1), ("child", 2),
                                               ("child", 3)]
    assert [s.parent for s in got] == [None] * 3
    assert profiling.dropped() == 2
    profiling.clear()
    assert recorded() == [] and profiling.dropped() == 0
    with recording():
        with annotate("again"):
            mark("m", 0.0, 1.0)
    assert [s.parent for s in recorded()] == [None, 0]


def test_trace_writes_chrome_trace(tmp_path):
    """trace() writes one Chrome trace into log_dir, with the annotated
    span in it."""
    with trace(str(tmp_path)) as d:
        assert d == str(tmp_path)
        with annotate("traced-span"):
            torch.ones(64).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "traced-span" for e in events)


def test_warn_of_sync_without_a_card():
    """Without a card there is nothing to wait for: the context runs its
    body and does nothing else."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ran = []
    with warn_of_sync():
        ran.append(1)
    assert ran == [1]


@pytest.mark.cuda
def test_sass_dump_on_card(tmp_path):
    """K1's library disassembled: sm_90a SASS of its kernels, written to
    dump_dir."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    txt = sass_dump("mxu_matvec", dump_dir=str(tmp_path))
    assert "sm_90a" in txt and "Function" in txt
    assert (tmp_path / "mxu_matvec.sass.txt").read_text() == txt


@pytest.mark.cuda
def test_warn_of_sync_on_card():
    """The sync debug mode is "warn" (1) inside and restored after; a host
    read inside warns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.cuda.get_sync_debug_mode()
    with warn_of_sync():
        assert torch.cuda.get_sync_debug_mode() == 1
        with pytest.warns(UserWarning):
            torch.ones(4, device="cuda").sum().item()
    assert torch.cuda.get_sync_debug_mode() == before
