"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the port (effort_tpu_torch). The
cell (BENCHMARK.json) names a configuration and a traffic mix; the
configuration's model_type names its architecture
(architectures/<model_type>.py: shapes, build, cache state, reference,
work counts), and the mix names its driver. The run: set-up (weights
made on the card from the seed, the program's own assembly, warm-up of
every shape the traffic uses), the measured window (--trace 1: a shorter
traced window under torch.profiler), then, with the program freed, the
architecture's own reference over a sample of what the window served,
which decides `correct`. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error.

--variant int4 builds the program with int4 buckets where the
configuration states int8: the lower-precision control, for the control
measurements only (the reference keeps what the configuration states).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "effort_tpu")


def _paths() -> None:
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # caches of the program and of its libraries stay in the checkout, at
    # fixed paths (the port's nvcc builds go to build/kernels/ itself)
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    """Modules of sys.modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a driver needs: the cell's data, its architecture (`arch`),
    the seed's plan, the spans, and build() for the program, on
    `device`."""

    def __init__(self, man, cell: dict, seed: int, variant: str,
                 device: str):
        from harness import traffic
        from harness.trace import Spans
        self.cell, self.seed = cell, seed
        self.arch = man.architecture(cell["config"])
        self.cfg_file = man.config(cell["config"])
        self.dims = self.arch.dims(self.cfg_file)
        self.mix = man.traffic(cell["traffic"])
        self.plan = traffic.Plan(self.mix, seed, self.dims.vocab,
                                 self.dims.max_seq_len)
        self.spans = Spans()
        self.bucket = dict(self.cfg_file["bucket"])
        if variant == "int4":
            self.bucket["dtype"] = "int4"
        self.src = None
        self.device = device

    def build(self):
        w, cfg, self.src = self.arch.build(self.cell["config"], self.dims,
                                           self.bucket, self.seed,
                                           self.device)
        return w, cfg, self.src

    def sync(self) -> None:
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()


def reference_logits(run, items: list, work=None, state=None,
                     kv_err=None) -> list:
    """The reference's logits at each item's served positions, each
    position one step from the program's state when `state` is given."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = run.cfg_file["bucket"]
    ref = run.arch.Reference(run.src, run.dims, probes=b["probes"],
                             base_rows=b["chunk_rows"])
    with torch.no_grad():
        return ref.forward([it[0] for it in items], [it[1] for it in items],
                           run.mix["effort"], run.mix["reference_tau"], work,
                           state, kv_err)


def compare(items: list, logits: list, kv_err: list) -> dict:
    """The served tokens against the reference: by how much each served
    token's reference logit lies below the reference's best (the widest
    gap, quantiles, the mean, the share at the best), and the program's
    key and value rows against the reference's own (relative errors: the
    largest at the first layer, which only the token feeds, and the
    median over every layer)."""
    import torch
    gaps = []
    for (_, _, targets), lg in zip(items, logits):
        t = torch.as_tensor(targets, device=lg.device)
        gaps.append(lg.max(dim=1).values
                    - lg.gather(1, t[:, None].long())[:, 0])
    g = torch.cat(gaps).double()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99, 0.25],
                                       dtype=g.dtype, device=g.device))
    return {"widest_gap": float(g.max()),
            "served_tokens": int(g.numel()),
            "reference_top1_share": float((g <= 0).double().mean()),
            "mean_gap": float(g.mean()), "median_gap": float(q[0]),
            "p90_gap": float(q[1]), "p99_gap": float(q[2]),
            "q1_gap": float(q[3]),
            "kv_first_layer_max": float(kv_err[0].max()),
            "kv_median": float(torch.cat(kv_err).median())}


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", choices=("int4",), default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    from harness import spec
    cell = spec.Manifest(ROOT).cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"no CUDA device, or fewer than {cell['chips']}: the cell "
              f"runs only on the card", file=sys.stderr)
        return 3
    out = run_cell(args, ROOT, "cuda")
    if out is None:
        return 4
    print(json.dumps(out), flush=True)
    return 0


def run_cell(args, root: Path, device: str):
    """One run of the cell on `device` ("cuda"; the CPU only in the
    benchmark's own tests): the result's dict, or None when a forbidden
    module is loaded once everything the run imports has been imported."""
    from harness import spec
    from harness.trace import profiled
    import torch
    man = spec.Manifest(root)
    cell = man.cell(args.workload)
    limits = man.limits(cell["name"])
    traced = bool(args.trace)
    on_card = device == "cuda"
    run = Run(man, cell, args.seed, args.variant, device)
    run.spans.annotate = traced
    driver = man.module("drivers", run.mix["driver"]).Driver(run)

    t0 = time.perf_counter()
    driver.setup()
    run.sync()
    setup_s = time.perf_counter() - t0

    prof: dict = {}
    with profiled(traced, prof, on_card):
        rec = driver.window(args.seconds, traced)
    run.sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e2e = driver.end_to_end(rec)
    got = driver.items(rec, traced)
    items, steps = got["judged"], got["steps"]
    driver.release()
    del driver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    from harness import readings
    work = readings.WorkLog() if traced else None
    kv_err: list = []
    own = got["work_items"] is None
    logits = reference_logits(run, items, work if own else None,
                              got["state"], kv_err) if items else []
    numbers = compare(items, logits, kv_err) if items else {
        "served_tokens": 0}
    work_items = items if own else got["work_items"]
    if traced and not own and work_items:
        reference_logits(run, [(s, [], []) for s, _, _ in work_items], work)
    compared = {k: {"value": numbers.get(k), "limit": v["limit"]}
                for k, v in limits.items() if not k.startswith("_")}
    correct = bool(items) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values())

    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    device_out = {"platform": "gpu" if on_card else "cpu", "kind": card,
                  "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": numbers["served_tokens"],
           "failed": 0 if correct else numbers["served_tokens"]}
    if traced:
        r = readings.Readings(run, prof["trace"], work_items, steps, work,
                              card)
        device_out.update(busy_s=r.busy_s, window_s=r.window_s)
        metrics, silent = {}, []
        for m in man.metrics(cell["name"], "per_layer"):
            v = man.module("metrics", m["name"]).read(r)
            if v is None:
                silent.append(m["name"])
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if silent:
            print(f"per-layer metrics that read nothing: {silent}",
                  file=sys.stderr)
        out["breakdown"] = r.breakdown()
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in man.metrics(cell["name"], "end_to_end")}
    out.update(metrics=metrics, device=device_out)
    from harness.traffic import quartiles
    # last, once the reference and every reader have been loaded and run
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return None
    info = {"setup_s": setup_s, "window_s": rec["t1"] - rec["t0"],
            "numbers": numbers, "counts": e2e.get("_counts", {}),
            "lengths": {k: quartiles(v)
                        for k, v in rec.get("lengths", {}).items()}}
    print(json.dumps({"info": info}), file=sys.stderr)
    for k, c in compared.items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out["compared"] = compared
    return out


if __name__ == "__main__":
    sys.exit(main())
