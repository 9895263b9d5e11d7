"""What bounds each part of the port's row-prefix matvec (K1) on an NVIDIA
GPU, by cutting the part out.

    python3 scripts/torch_k1_parts.py

Times `fused_stream.mxu_matvec` of the `effort_tpu_torch` package found in
the current directory at chip_smoke.py's K1 summary points (the four fused
Mistral-7B projections, int8 row-prefix values with chip_smoke.py's chunk
rows, effort 0.25, tau 0.97), L2 flushed, median over 8 fresh inputs, with
the device time of each of its kernels (torch.profiler, mean of 5 calls,
by chip_smoke.KERNEL_PARTS), once as it is and once for each variant built
from an edited copy of csrc/ under build/k1_parts/ (the results of a
variant are wrong by design; only its times mean anything):
  full    the kernels as they are
  nocut   the selection skips the cutoff search (k1_find_cutoff)
  nomass  the selection skips u and the chunk masses (for the rows it
          holds: their loads stay)
  noscan  the selection skips the chunk prefix that finds C (C is then 1,
          so the stream's time in this variant means nothing)
  nocomp  the stream skips the arithmetic (it folds each loaded word into
          one sum): its time is then that of moving its bytes
  noload  the stream loads no weights: its time is then that of its
          arithmetic
  empty   every launch returns at once: a call's fixed cost
The stream and the split sum are programmatic dependents: their device
times include their wait behind the launch before. Prints the card's name
and power limit and one JSON line per variant, and writes them to
k1_parts.json in chip_smoke.py's output directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effort_tpu_torch.config import BucketConfig  # noqa: E402
from effort_tpu_torch.kernels import _build, fused_stream  # noqa: E402
from effort_tpu_torch.ops.bucketize import (bucketize,  # noqa: E402
                                            calib_row_order, pick_chunk_rows)
from effort_tpu_torch.ops.effort import effort_q16  # noqa: E402
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_k4_parts import build_variant  # noqa: E402

RUNS = 8
PROFILED = 5

# Edits of csrc/mxu_matvec.cu: its grid selection (k1_select_kernel), its
# stream (k1_stream_kernel) and its split sum (k1_reduce_kernel).
VARIANTS = {
    "full": [],
    "nocut": [("mxu_matvec.cu",
               "  const float cutoff = k1_find_cutoff(v, P, stride, probes, "
               "eff, tables);",
               "  const float cutoff = eff;")],
    "nomass": [("mxu_matvec.cu", "  if (held)\n    rows.select(",
                "  if (false)\n    rows.select(")],
    "noscan": [("mxu_matvec.cu",
                "  const int C = chunk_prefix_len(s_seg, nc, tau);",
                "  const int C = 1;")],
    "nocomp": [("mxu_matvec.cu",
                "      for (int q = 0; q < kUnroll; ++q) fma_row<KIND>(acc, "
                "w[q], uu[q]);",
                "      for (int q = 0; q < kUnroll; ++q) acc[0] += "
                "__uint_as_float(w[q].x ^ w[q].y ^ w[q].z ^ w[q].w) * uu[q];"
                )],
    "noload": [("mxu_matvec.cu",
                "        w[q] = __ldcs(reinterpret_cast<const uint4*>(\n"
                "            vals + (size_t)rr * row_bytes + cb));",
                "        w[q] = make_uint4(rr, cb, rr ^ cb, rr + cb);")],
    "empty": [("mxu_matvec.cu", "  launch_dependents();\n  const int c0",
               "  launch_dependents();\n  if (P > 0) return;\n  const int "
               "c0"),
              ("mxu_matvec.cu", "  if (r0 >= r_end) return;",
               "  if (r0 >= 0) return;"),
              ("mxu_matvec.cu", "  if (j >= out_dim) return;",
               "  if (j > -1) return;")],
}

def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_k1_parts: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    dtype, effort, tau = cs.SUMMARY
    cases = []
    for name, (i, o) in cs.SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype)
        bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
        bm = bucketize(wt, bc, in_perm=pi)
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        cases.append((name, bm, vs))
        del wt
    eq = effort_q16(effort, "cuda")
    src = _build._SRC_DIR
    out = {"nvidia_smi": smi, "cwd": os.getcwd()}
    for var, edits in VARIANTS.items():
        build_variant(var, edits, src, "k1_parts")
        res = {}
        for name, bm, vs in cases:
            call = lambda v: fused_stream.mxu_matvec(  # noqa: E731
                bm, v, eq, 0, tau=tau)
            ms = cs.median([gpu_ms(call, (v,), flush) for v in vs])
            prof = cs.device_profile(
                lambda: [call(v) for v in vs[:PROFILED]])["kernel_ms"]
            res[name] = dict(ms=ms, parts_us={
                k: t * 1e3 / PROFILED for k, t in prof.items()
                if k.startswith("k1_")})
        res["sum_ms"] = sum(r["ms"] for r in res.values())
        res["parts_us_mean"] = {
            k: sum(res[n]["parts_us"].get(k, 0.0) for n, *_ in cases)
            / len(cases) for k in res[cases[0][0]]["parts_us"]}
        out[var] = res
        print(json.dumps({"variant": var, **res}), flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    with open(cs.OUT_DIR / "k1_parts.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
