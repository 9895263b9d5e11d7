"""The yardstick's arithmetic on tiny, hand-made inputs: rates, tails,
the union of spans, bytes of K1 and K2, and readers that find nothing."""

import pytest

from harness import readings, trace, work


def _serve_driver(reqs):
    """The serve driver's end-to-end arithmetic over hand-made requests."""
    import importlib.util
    from support import BENCH
    spec = importlib.util.spec_from_file_location(
        "serve_driver", BENCH / "drivers" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = object.__new__(mod.Driver)
    d.reqs = []
    for t_submit, times in reqs:
        q = mod.Request([3, 4], len(times), t_submit)
        q.times = list(times)
        d.reqs.append(q)
    return d


def test_rate_is_all_work_over_all_time_and_a_stall_moves_it():
    steady = [(0.0, [0.1 * i + 0.05 for i in range(1, 11)])]
    d = _serve_driver(steady)
    a = d.end_to_end({"t0": 0.0, "t1": 2.0})
    assert a["serve_tokens_per_s"] == pytest.approx(10 / 2.0)
    # the same tokens with a one-second stall before the last: the rate
    # is taken over the whole window, so the window's length decides
    stalled = [(0.0, [0.1 * i + 0.05 for i in range(1, 10)] + [2.5])]
    b = _serve_driver(stalled).end_to_end({"t0": 0.0, "t1": 3.0})
    assert b["serve_tokens_per_s"] == pytest.approx(10 / 3.0)
    assert b["itl_ms_p95"] > a["itl_ms_p95"]


def test_tails_are_taken_over_all_requests():
    # 20 requests: 18 fast first tokens, 2 slow; p90 sees the slow ones
    reqs = [(0.0, [0.01 + 0.001 * i, 0.5]) for i in range(18)]
    reqs += [(0.0, [0.9, 1.0]), (0.0, [0.95, 1.0])]
    e = _serve_driver(reqs).end_to_end({"t0": 0.0, "t1": 1.0})
    assert e["_counts"]["requests_first_token"] == 20
    assert e["ttft_ms_p90"] > 100.0


def test_union_counts_overlaps_once():
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_us([(0, 10), (2, 3)]) == 10
    assert trace.union_us([]) == 0


def test_k1_and_k2_bytes_on_tiny_shapes():
    # K1: 2 chunks of 8 rows streamed from a 64 x 32 int8 matrix, 16
    # probes: codes 16*32, v/stats/scales 64*4*3, probes 16*4, y 32*4
    w = work.effort_product(64, 32, 16, 16)
    assert w.bytes == 16 * 32 + 64 * 4 * 3 + 16 * 4 + 32 * 4
    assert w.flops == 2 * 16 * 32
    # K2 over 4 vectors sharing the prefix: codes once, V and Y 4 times
    w2 = work.effort_product(64, 32, 16, 16, T=4)
    assert w2.bytes == 16 * 32 + 64 * 4 * 2 + 4 * 64 * 4 + 16 * 4 \
        + 4 * 32 * 4
    assert w2.flops == 2 * 4 * 16 * 32
    pk = {"bytes_per_s": 1e9, "flops_per_s": 1e9}
    assert w.least_s(pk) == pytest.approx(w.bytes / 1e9)


def _readings(ops, notes):
    r = object.__new__(readings.Readings)
    r.trace = trace.Trace(ops, notes)
    r.t0, r.t1 = 0.0, 100.0
    r.ops = r.trace.ops
    r.steps, r.step_tokens, r.entries = [], [], []
    return r


def test_calls_group_a_kernels_launches():
    ops = [("k1_select_kernel", 0, 2), ("k1_stream_kernel", 1, 5),
           ("other", 5, 6), ("k1_reduce_kernel", 6, 7),
           ("k1_select_kernel", 10, 11), ("k1_stream_kernel", 11, 14)]
    r = _readings(ops, [("window", 0, 100)])
    assert r.calls("k1_select_kernel",
                   ("k1_stream_kernel", "k1_reduce_kernel")) == [
        (0, 7), (10, 14)]


def test_a_kernel_name_that_matches_nothing_reads_nothing():
    """A reader whose kernels are not in the trace returns None, never 0:
    the harness leaves the metric out of the line and names it on
    standard error (a kernel taken off the path leaves its roofline
    silent; step_mfu, which matches no kernel name, still bounds it)."""
    import importlib.util
    from support import BENCH
    r = _readings([("some_other_kernel", 0, 5)], [("window", 0, 100)])
    for name in ("k1_roofline.decode", "k2_roofline.serve",
                 "moe_route_ms.decode"):
        spec = importlib.util.spec_from_file_location(
            name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.read(r) is None


def test_idle_gaps_are_labelled_by_host_spans():
    ops = [("a", 0, 10), ("b", 30, 40)]
    notes = [("window", 0, 50), ("admit", 5, 35)]
    gaps = trace.idle_gaps(ops, notes, 0, 50)
    assert gaps == [("admit", 20), ("host", 10)]
