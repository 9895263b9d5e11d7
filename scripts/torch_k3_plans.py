"""K3 (the port's flash attention) under every launch plan its kernel
takes, and with fewer bf16 parts of P under pv_f32, on an NVIDIA GPU.

    python3 scripts/torch_k3_plans.py

At each of chip_smoke.py's attention cases (512-slot cache), with the
`effort_tpu_torch` package found in the current directory:
  plans  times `flash_attention_seq` with each plan of rw row warps x kw
         key warps (rw 1, 2, 4; kw 2, 4; at most 8 warps; rw * 16 >= rep),
         L2 flushed, median over 10 fresh inputs, each checked against the
         plain version by chip_smoke.py's gate, and names the plan
         `flash_plan` picks;
  parts  reads chip_smoke.py's K3 gate (attention_agreement, on its own
         inputs: seed 99, attention_inputs) under pv_f32 with P taken as
         one, two or three bf16 parts (three is the kernel as it is; one
         and two come from an edited copy of csrc/ under build/k3_parts/),
         to show where the gate's max|dy| limit sits between them.
Prints the card's name and power limit and one JSON line per case and
section, and writes them to k3_plans.json in chip_smoke.py's output
directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effort_tpu_torch.kernels import _build  # noqa: E402
from effort_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_k4_parts import build_variant  # noqa: E402

RUNS = 10
_PARTS_LOOP = "            if (part > 0 && !a.pv_f32) break;"
# P under pv_f32 in fewer bf16 parts than the kernel's three
PARTS = {"p1": [("flash_attention.cu", _PARTS_LOOP,
                 "            if (part > 0) break;")],
         "p2": [("flash_attention.cu", _PARTS_LOOP,
                 "            if (part > 1 || (part > 0 && !a.pv_f32)) "
                 "break;")]}


def plans(flush, sms: int) -> list:
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    picker, out = fa.flash_plan, []
    try:
        for case in cs.ATTN_CASES:
            dims, _, kc, vc, Qs = cs.attention_inputs(case, g)
            T, start, mf, win, H, KV, D = dims
            rep = H // KV

            def run(q, plain=False):
                return fa.flash_attention_seq(q, kc, vc, start, mf, H, D,
                                              window=win, plain=plain)
            ref = run(Qs[0], plain=True)
            res = {}
            for rw in (1, 2, 4):
                for kw in (2, 4):
                    if rw * kw > 8 or 16 * rw < rep:
                        continue
                    bq = 16 * rw // rep
                    plan = fa.FlashPlan(rw, kw, bq, -(-T // bq), KV)
                    fa.flash_plan = lambda *a, p=plan: p  # noqa: E731
                    ok = cs.attention_agreement(dims, run(Qs[0]), ref)["ok"]
                    ms = cs.median([gpu_ms(run, (q,), flush)
                                    for q in Qs[:RUNS]])
                    res[f"{rw}x{kw}"] = dict(ms=ms, ok=ok)
            fa.flash_plan = picker
            p = picker(T, rep, KV, sms)
            out.append({"section": "plans", "case": case["name"],
                        "picked": f"{p.rw}x{p.kw}", **res})
            print(json.dumps(out[-1]), flush=True)
    finally:
        fa.flash_plan = picker
    return out


def parts() -> list:
    src, out = _build._SRC_DIR, []
    for var, edits in [("p3", [])] + list(PARTS.items()):
        build_variant(var, edits, src, "k3_parts")
        g = torch.Generator(device="cuda")
        g.manual_seed(99)                          # chip_smoke's inputs
        res = {}
        for case in cs.ATTN_CASES:
            dims, _, kc, vc, Qs = cs.attention_inputs(case, g)
            T, start, mf, win, H, KV, D = dims
            y, yr = (fa.flash_attention_seq(Qs[0], kc, vc, start, mf, H, D,
                                            window=win, plain=plain)
                     for plain in (False, True))
            a = cs.attention_agreement(dims, y, yr)
            res[case["name"]] = dict(
                rel_err=a["max_abs_err"] / a["max_abs_ref"],
                min_row_cos=a["min_row_cos"], ok=a["ok"])
        out.append({"section": "parts", "variant": var,
                    "tol": cs.PV_F32_TOL, **res})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_k3_plans: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = plans(flush, sms) + parts()
    cs.OUT_DIR.mkdir(exist_ok=True)
    with open(cs.OUT_DIR / "k3_plans.json", "w") as f:
        json.dump({"nvidia_smi": smi, "cwd": os.getcwd(), "rows": out}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
