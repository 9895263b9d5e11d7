"""Device times of the port's rank-prefix matvecs (K4-K7) on an NVIDIA GPU,
and the greedy tokens of the "gather" route (K6).

    python3 scripts/torch_rank_times.py

Times `fused_stream.fused_matvec` (K4), `prefix_stream.stream_matvec` (K5),
`gather_dma.gather_matvec_dma` (K6) and `gather_mul.gather_bucket_matvec`
(K7) of the `effort_tpu_torch` package found in the current directory at
the four fused Mistral-7B projections, int8 rank-prefix values (B = 4, G =
16), effort 0.25, tau 0.97, K6 and K7 at the gather route's capacity
(chip_smoke.py's summary points), L2 flushed, median over 10 fresh
inputs. Then chip_smoke.py's 32-layer int8 rank-prefix model (B = 4, G =
16, seed 0) decodes its first prompt through Engine(impl="gather",
pad_to=8) at effort 0.25: 4 greedy tokens, the launch counts and the host
ms a token after a warm-up. Run it from the root of two checkouts in turns
to compare them on one card. Prints the card's name and power limit, one
JSON line per shape, the sums over the four shapes and the decode.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effort_tpu_torch.config import BucketConfig  # noqa: E402
from effort_tpu_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from effort_tpu_torch.kernels import (fused_stream, gather_dma,  # noqa: E402
                                      gather_mul, prefix_stream)
from effort_tpu_torch.models.generate import Engine  # noqa: E402
from effort_tpu_torch.ops import bucketmul  # noqa: E402
from effort_tpu_torch.ops.bucketize import (bucketize,  # noqa: E402
                                            calib_row_order)
from effort_tpu_torch.ops.effort import effort_q16, select_blocks  # noqa
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
          "w13": (4096, 28672), "w2": (14336, 4096)}
EFFORT, TAU = 0.25, 0.97
RUNS = 10


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_rank_times: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1357)
    eq = effort_q16(EFFORT, "cuda")
    total = dict.fromkeys(("k4", "k5", "k6", "k7"), 0.0)
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        bm = bucketize(wt, BucketConfig(dtype="int8", bucket_size=4,
                                        chunk_rows=16), in_perm=pi)
        del wt
        tgb = bucketmul._tile_blocks(bm)
        cap = bucketmul.gather_capacity(bm, EFFORT)
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        streams = [prefix_stream.select_stream(bm, v, eq, 0, tgb, tau=TAU)
                   for v in vs]
        blocks = [select_blocks(bm, v, EFFORT, 0, cap) for v in vs]
        pos7 = gather_mul.unpacked_positions(bm)
        ms = {
            "k4": median([gpu_ms(lambda a: fused_stream.fused_matvec(
                bm, a, eq, 0, tgb, TAU), (v,), flush) for v in vs]),
            "k5": median([gpu_ms(lambda s: prefix_stream.stream_matvec(
                bm, s, tgb), (s,), flush) for s in streams]),
            "k6": median([gpu_ms(lambda s: gather_dma.gather_matvec_dma(
                bm, s), (s,), flush) for s in blocks]),
            "k7": median([gpu_ms(lambda s: gather_mul.gather_bucket_matvec(
                bm, s, pos7), (s,), flush) for s in blocks])}
        for k, t in ms.items():
            total[k] += t
        print(json.dumps({"shape": name, **ms}), flush=True)
    print(json.dumps({"sum_ms": total, "cwd": os.getcwd()}), flush=True)
    del bm, streams, blocks, pos7, flush
    torch.cuda.empty_cache()
    cfg, w = cs.build_rank_model()
    prompt = torch.randint(3, cfg.vocab_size, (cs.PROMPT_LENS[0],),
                           generator=torch.Generator().manual_seed(7)
                           ).tolist()                  # chip_smoke's first
    eng = Engine(w, cfg, impl="gather", eos_id=-1, pad_to=8)
    eng.generate(prompt, n_new=2, effort=EFFORT)       # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rep = eng.generate(prompt, n_new=4, effort=EFFORT)
    torch.cuda.synchronize()
    steps = 8 + 4 - 1
    print(json.dumps({"gather_tokens": rep.token_ids,
                      "launches": {k: n for k, n in LAUNCHES.items() if n},
                      "ms_per_token": (time.perf_counter() - t0) * 1e3
                      / steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
