"""K9 (the port's latent attention, kernels/mla_decode) alone on an NVIDIA
GPU, at DeepSeek-V2-Lite's widths over a 4096-row latent cache.

    python3 scripts/torch_k9_times.py

With the `effort_tpu_torch` package found in the current directory: at
positions 255, 1023 and 4095 (the live rows 256, 1024, 4096) times
`mla_decode` with its own plan and with 1, 2, 4 and 8 tiles at least a
chunk (L2 flushed, median over fresh queries, each call first checked
against the plain version within 1e-4 of its largest output), beside the
plain version's time and the bound: the live rows' bytes and the queries'
and outputs' at 3.35 TB/s, or 2 x 16 x (576 + 512) operations a live row
at 989 TFLOP/s, whichever is longer. Prints the card's name and power limit
and one JSON line per position, and writes them to chiprun_out/k9_times.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from effort_tpu_torch.kernels import mla_decode as k9  # noqa: E402
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

S, H, W, R = 4096, 16, 576, 512
SCALE = 0.11472
POSITIONS = (255, 1023, 4095)
MIN_TILES = (1, 2, 4, 8)
REPEATS = 15


def bound_ms(rows: int) -> float:
    by = rows * W * 2 + H * (W + R) * 4
    return 1e3 * max(by / 3.35e12, 2.0 * H * (W + R) * rows / 9.89e14)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_k9_times: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(97)
    cache = torch.randn((1, S, W), generator=g, device="cuda").to(
        torch.bfloat16)
    qs = [torch.randn((1, H, W), generator=g, device="cuda")
          for _ in range(REPEATS)]
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    own = k9.mla_plan(S, sms)
    lines = []
    for p in POSITIONS:
        pos = torch.full((1,), p, dtype=torch.int32, device="cuda")
        want = k9.mla_decode_ref(qs[0], cache, pos, zero, SCALE)
        row = {"pos": p, "live_rows": p + 1, "plan": own._asdict(),
               "bound_ms": bound_ms(p + 1)}
        for mt in MIN_TILES:
            plan = k9.MlaPlan(max(1, min(sms, -(-(S // 16) // mt))), mt)
            k9.mla_plan = lambda S_, sms_, plan=plan: plan
            got = k9.mla_decode(qs[0], cache, pos, zero, SCALE)
            err = float((got - want).abs().max() / want.abs().max())
            if err > 1e-4:
                raise AssertionError(f"K9 at {p}, {plan}: {err}")
            ms = sorted(gpu_ms(k9.mla_decode, (q, cache, pos, zero, SCALE),
                               flush) for q in qs)
            row[f"k9_ms_min_tiles_{mt}"] = ms[len(ms) // 2]
        k9.mla_plan = lambda S_, sms_: own
        ms = sorted(gpu_ms(k9.mla_decode, (q, cache, pos, zero, SCALE),
                           flush) for q in qs)
        row["k9_ms"] = ms[len(ms) // 2]
        ms = sorted(gpu_ms(k9.mla_decode_ref, (q, cache, pos, zero, SCALE),
                           flush) for q in qs[:5])
        row["plain_ms"] = ms[len(ms) // 2]
        print(json.dumps(row), flush=True)
        lines.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k9_times.json"), "w") as f:
        json.dump({"card": smi.strip(), "rows": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
