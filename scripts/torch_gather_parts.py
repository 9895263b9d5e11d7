"""What bounds the port's block-gather matvecs (K6, K7) on an NVIDIA GPU, by
cutting parts of their shared body out.

    python3 scripts/torch_gather_parts.py

Times `gather_dma.gather_matvec_dma` (K6) and
`gather_mul.gather_bucket_matvec` (K7) of the `effort_tpu_torch` package
found in the current directory at the four fused Mistral-7B projections
(int8 rank-prefix values, B = 4, G = 16, effort 0.25 at the gather route's
capacity: chip_smoke.py's K6/K7 summary points), L2 flushed, median over 8
fresh selections, with the device time of each kernel (torch.profiler,
mean of 5 calls), once as it is and once for each variant built from an
edited copy of csrc/ under build/gather_parts/ (the results of a variant
are wrong by design; only its times mean anything):
  full    the kernels as they are
  nocomp  the consumer warps skip every row: the gather's time is then that
          of moving its bytes through the ring
  noload  the producer copies nothing: the gather's time is then that of
          its arithmetic
  noskip  rows whose u is 0 are computed too (the skip changes no bit)
  empty   no id is walked: the fixed cost of a call (the launches, a
          block's set-up, its zero partial sums, the split sum)
Beside each shape: the real ids, the share of their rows whose u is 0, and
the bytes bound (chip_smoke.gather_bytes over 3.35 TB/s). Prints the card's
name and power limit and one JSON line per variant, and writes them to
gather_parts.json in chip_smoke.py's output directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effort_tpu_torch.config import BucketConfig  # noqa: E402
from effort_tpu_torch.kernels import _build, gather_dma  # noqa: E402
from effort_tpu_torch.kernels import gather_mul  # noqa: E402
from effort_tpu_torch.ops import bucketmul  # noqa: E402
from effort_tpu_torch.ops.bucketize import (bucketize,  # noqa: E402
                                            calib_row_order)
from effort_tpu_torch.ops.effort import select_blocks  # noqa: E402
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402
from torch_k4_parts import build_variant  # noqa: E402

RUNS = 8
PROFILED = 5
EFFORT = 0.25
SKIP = "        if (!active || uu == 0.f) continue;"
VARIANTS = {
    "full": [],
    "nocomp": [("block_gather.cuh", SKIP,
                "        if (!active || uu == 0.f || true) continue;")],
    "noload": [("block_gather.cuh",
                "        mbar_expect_tx(&full[slot], bytes);\n"
                "        for (int i = 0; i < nbox; ++i)",
                "        mbar_arrive(&full[slot]);\n"
                "        for (int i = 0; i < 0; ++i)")],
    "noskip": [("block_gather.cuh", SKIP,
                "        if (!active) continue;")],
    "empty": [("block_gather.cuh",
               "  const int units = (n_real - 1 - (int)blockIdx.y) / "
               "(int)gridDim.y + 1;",
               "  const int units = 0;")],
}


def zero_u_share(bm, sel) -> float:
    """The share of the real ids' rows whose u is 0."""
    K, nc = bm.n_ranks, bm.n_chunks
    ids = sel.block_ids[:int(sel.n_blocks)].long()
    u = sel.u_scaled[(ids // nc) % K, ids % nc]
    return float((u == 0).float().mean())


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_gather_parts: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(2468)
    cases, shapes = [], {}
    for name, (i, o) in cs.SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        bm = bucketize(wt, BucketConfig(dtype="int8", **cs.RANK_BUCKETS),
                       in_perm=pi)
        del wt
        cap = bucketmul.gather_capacity(bm, EFFORT)
        sels = [select_blocks(bm, rms[pi.long()] * torch.randn(
            i, generator=g, device="cuda"), EFFORT, 0, cap)
            for _ in range(RUNS)]
        pos7 = gather_mul.unpacked_positions(bm)
        real = min(int(sels[0].n_blocks), cap)
        shapes[name] = dict(
            max_blocks=cap, real_ids=real,
            zero_u_rows=zero_u_share(bm, sels[0]),
            bound_ms_k6=cs.gather_bytes(bm, real, bm.pos.shape[2])
            / cs.HBM_BYTES_PER_S * 1e3,
            bound_ms_k7=cs.gather_bytes(bm, real, pos7.shape[2])
            / cs.HBM_BYTES_PER_S * 1e3)
        cases.append((name, bm, sels, pos7))
    print(json.dumps({"shapes": shapes}), flush=True)
    calls = {"k6": lambda bm, s, p7: gather_dma.gather_matvec_dma(bm, s),
             "k7": lambda bm, s, p7: gather_mul.gather_bucket_matvec(
                 bm, s, p7)}
    src = _build._SRC_DIR
    out = {"nvidia_smi": smi, "effort": EFFORT, "shapes": shapes}
    for var, edits in VARIANTS.items():
        build_variant(var, edits, src, "gather_parts")
        res = {}
        for kern, call in calls.items():
            r = {}
            for name, bm, sels, pos7 in cases:
                fn = lambda s: call(bm, s, pos7)  # noqa: E731
                ms = cs.median([gpu_ms(fn, (s,), flush) for s in sels])
                prof = cs.device_profile(
                    lambda: [fn(s) for s in sels[:PROFILED]])["kernel_ms"]
                r[name] = dict(ms=ms, parts_us={
                    k: t * 1e3 / PROFILED for k, t in prof.items()})
            r["sum_ms"] = sum(x["ms"] for x in r.values())
            res[kern] = r
        out[var] = res
        print(json.dumps({"variant": var, **res}), flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    with open(cs.OUT_DIR / "gather_parts.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
