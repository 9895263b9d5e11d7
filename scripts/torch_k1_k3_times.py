"""Device times of the port's K1-K5 on an NVIDIA GPU, for comparing two
checkouts on one card.

    python3 scripts/torch_k1_k3_times.py

Times, with the package found in the current directory, L2 flushed, median
over 10 fresh inputs:
  k1        fused_stream.mxu_matvec at chip_smoke.py's K1 summary points
            (the four fused Mistral-7B projections, int8 row-prefix values,
            effort 0.25, tau 0.97), summed over the four
  k2_t4, k2_t64
            fused_stream.mxu_matvec_batch at the same four projections,
            T = 4 and 64 slots at chip_smoke.py's mixed efforts
  k3        flash_attention_seq at each of the checkout's chip_smoke.py
            attention cases (ATTN_CASES, over a 512-slot cache; null where
            the checkout's kernel refuses the case's heads)
  k4, k5    fused_stream.fused_matvec and prefix_stream.stream_matvec at
            the four projections, int8 rank-prefix values (B = 4, G = 16),
            effort 0.25, tau 0.97
and the device time a call of K1, K2 and K4 spends in each of its kernels
(torch.profiler, mean of 5 calls, by chip_smoke.KERNEL_PARTS). Run it from
the root of two checkouts in turns (parent, change, change, parent). Prints
the card's name and power limit and one JSON line of results.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effort_tpu_torch.config import BucketConfig  # noqa: E402
from effort_tpu_torch.kernels import fused_stream, prefix_stream  # noqa
from effort_tpu_torch.kernels.flash_attention import \
    flash_attention_seq  # noqa: E402
from effort_tpu_torch.ops import bucketmul  # noqa: E402
from effort_tpu_torch.ops.bucketize import (bucketize,  # noqa: E402
                                            calib_row_order, pick_chunk_rows)
from effort_tpu_torch.ops.effort import effort_q16  # noqa: E402
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

RUNS = 10
PROFILED = 5
EFFORT, TAU = 0.25, 0.97


def parts(fn, prefix: str) -> dict:
    """Device us a call spends in each kernel whose part name starts with
    prefix (PROFILED calls made by fn)."""
    prof = cs.device_profile(fn)["kernel_ms"]
    return {k: t * 1e3 / PROFILED for k, t in prof.items()
            if k.startswith(prefix)}


def times(flush) -> dict:
    g = torch.Generator(device="cuda")
    g.manual_seed(2025)
    eq = effort_q16(EFFORT, "cuda")
    out = {k: 0.0 for k in ("k1", "k2_t4", "k2_t64", "k4", "k5")}
    prof = {k: {} for k in ("k1", "k2_t4", "k2_t64", "k4")}

    def add_parts(key, p):
        for k, us in p.items():
            prof[key][k] = prof[key].get(k, 0.0) + us

    for name, (i, o) in cs.SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
        bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
        bm = bucketize(wt, bc, in_perm=pi)
        bm4 = bucketize(wt, BucketConfig(dtype="int8", **cs.RANK_BUCKETS),
                        in_perm=pi)
        del wt
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        k1 = lambda v: fused_stream.mxu_matvec(bm, v, eq, 0,  # noqa: E731
                                               tau=TAU)
        out["k1"] += cs.median([gpu_ms(k1, (v,), flush) for v in vs])
        add_parts("k1", parts(lambda: [k1(v) for v in vs[:PROFILED]], "k1_"))
        for T in (4, 64):
            eff = cs.batch_efforts(T)
            Vs = [rms[pi.long()] * torch.randn((T, i), generator=g,
                                               device="cuda")
                  for _ in range(RUNS)]
            k2 = lambda V: fused_stream.mxu_matvec_batch(  # noqa: E731
                bm, V, eff, 0, tau=TAU)
            out[f"k2_t{T}"] += cs.median([gpu_ms(k2, (V,), flush)
                                          for V in Vs])
            add_parts(f"k2_t{T}", parts(
                lambda: [k2(V) for V in Vs[:PROFILED]], "k2_"))
        tgb = bucketmul._tile_blocks(bm4)
        k4 = lambda v: fused_stream.fused_matvec(bm4, v, eq, 0,  # noqa
                                                 tgb, TAU)
        out["k4"] += cs.median([gpu_ms(k4, (v,), flush) for v in vs])
        add_parts("k4", parts(lambda: [k4(v) for v in vs[:PROFILED]], "k4"))
        sels = [prefix_stream.select_stream(bm4, v, eq, 0, tgb, tau=TAU)
                for v in vs]
        out["k5"] += cs.median([gpu_ms(
            lambda s: prefix_stream.stream_matvec(bm4, s, tgb), (s,), flush)
            for s in sels])
        del bm, bm4, sels
        torch.cuda.empty_cache()
    out["parts_us"] = prof
    out["k3"] = {}
    for case in cs.ATTN_CASES:
        name, T, start, mf, win = (case["name"], case["T"],
                                   case["start_slot"], case["mask_from"],
                                   case["window"])
        H, KV, D = case.get("H", 32), case.get("KV", 8), case.get("D", 128)
        S = 512
        kc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
        vc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
        Qs = [torch.randn((T, H * D), generator=g, device="cuda")
              for _ in range(RUNS)]
        k3 = lambda q: flash_attention_seq(q, kc, vc, start, mf,  # noqa
                                           H, D, window=win)
        try:
            k3(Qs[0])
        except ValueError:
            out["k3"][name] = None
            continue
        out["k3"][name] = cs.median([gpu_ms(k3, (q,), flush) for q in Qs])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_k1_k3_times: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    print(json.dumps({"cwd": os.getcwd(), **times(flush)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
