"""Device times of the port's batched effort matmul (K2) on an NVIDIA GPU.

    python3 scripts/torch_k2_times.py [T ...]        (default: 4 64)

Times `fused_stream.mxu_matvec_batch` of the `effort_tpu_torch` package
found in the current directory at the four fused Mistral-7B projections,
int8 row-prefix values, tau 0.97, per-slot efforts 0.1/0.25/0.5/1.0 with the
last slot at 0 (chip_smoke.py's K2 points), L2 flushed, median over 10
fresh inputs. Run it from the root of two checkouts in turns to compare
them on one card. Prints one JSON line per shape and T, then the sum over
the four shapes for each T.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from effort_tpu_torch.config import BucketConfig  # noqa: E402
from effort_tpu_torch.kernels import fused_stream  # noqa: E402
from effort_tpu_torch.ops.bucketize import (bucketize,  # noqa: E402
                                            calib_row_order, pick_chunk_rows)
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
          "w13": (4096, 28672), "w2": (14336, 4096)}
EFFORTS = (0.1, 0.25, 0.5, 1.0)
RUNS = 10


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_k2_times: needs an NVIDIA GPU")
    Ts = [int(t) for t in sys.argv[1:]] or [4, 64]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    total = dict.fromkeys(Ts, 0.0)
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
        bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
        bm = bucketize(wt, bc, in_perm=pi)
        for T in Ts:
            e = [EFFORTS[t % len(EFFORTS)] for t in range(T)]
            e[-1] = 0.0
            eff = torch.tensor(e, device="cuda")
            Vs = [rms[pi.long()] * torch.randn((T, i), generator=g,
                                               device="cuda")
                  for _ in range(RUNS)]
            ms = sorted(gpu_ms(lambda v: fused_stream.mxu_matvec_batch(
                bm, v, eff, 0, tau=0.97), (v,), flush) for v in Vs)[RUNS // 2]
            total[T] += ms
            print(json.dumps({"shape": name, "T": T, "ms": ms}), flush=True)
        del bm, wt
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "sum_ms_by_T": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
