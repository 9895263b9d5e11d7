"""K8 (the port's decode attention) at every chunk length its plan can
take, on an NVIDIA GPU.

    python3 scripts/torch_k8_plans.py

At chip_smoke.py's decode cases (Mistral-7B chat, 16 serving slots,
Llama-2-7B's MHA) and at more positions of each (a short conversation, a
full cache, every serving slot near its end), with the `effort_tpu_torch`
package found in the current directory: times `decode_attention` with
each chunk length of 1 to 32 tiles (L2 flushed, median over fresh
queries, each call checked against the plain version by chip_smoke.py's
K8_TOL), beside the bound (the live rows' bytes) and the chunk length
`decode_plan` picks. Prints the card's name and power limit and one JSON
line per case, and writes them to k8_plans.json in chip_smoke.py's
output directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effort_tpu_torch.kernels import decode_attention as k8  # noqa: E402
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

CHUNK_TILES = (1, 2, 4, 8, 16, 32)
# (name, base case of chip_smoke.DECODE_CASES, positions)
CASES = (
    ("chat_64", "chat", [64]), ("chat_1024", "chat", [1024]),
    ("chat_2047", "chat", [2047]), ("serve", "serve", "serve"),
    ("serve_full", "serve", [2000 + 3 * b for b in range(16)]),
    ("llama2_1024", "llama2", [1024]), ("llama2_2048", "llama2", [2048]),
    ("llama2_4095", "llama2", [4095]),
)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_k8_plans: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(97)
    base = {c["name"]: c for c in cs.DECODE_CASES}
    picker, lines = k8.decode_plan, []
    for name, case, pos in CASES:
        c = dict(base[case], pos=pos)
        B, S, KV, rep, D = (c[k] for k in ("B", "S", "KV", "rep", "D"))
        k, v, qs, p, offs, live = cs.decode_inputs(c, g)
        n_live = int(live.sum())
        nbytes = 2 * n_live * KV * D * 2 + 2 * B * KV * rep * D * 4
        picked = picker(B, KV, rep, S, D, sms)
        row = dict(case=name, B=B, S=S, KV=KV, rep=rep, D=D,
                   live_rows=n_live,
                   bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                   picked_chunk_tiles=picked.chunk_tiles, ms={})
        try:
            for ct in CHUNK_TILES:
                n_tiles = -(-S // picked.tile)
                n = -(-n_tiles // ct)
                if n > k8._MAX_CHUNKS or ct > n_tiles:
                    continue
                plan = picked._replace(chunk_tiles=ct, n_chunks=n)
                k8.decode_plan = lambda *a, pl=plan: pl  # noqa: E731
                y = k8.decode_attention(qs[0], k, v, p, offs)
                yr = k8.attn_core(qs[0], k.float(), v.float(), live, KV,
                                  rep, D)
                err = float((y - yr).abs().max())
                if err > cs.K8_TOL * float(yr.abs().max()):
                    raise AssertionError(f"{name} at {ct} tiles: {err}")
                row["ms"][ct] = cs.median([gpu_ms(
                    lambda q: k8.decode_attention(q, k, v, p, offs), (q,),
                    flush) for q in qs])
        finally:
            k8.decode_plan = picker
        lines.append(row)
        print(json.dumps(row), flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    with open(cs.OUT_DIR / "k8_plans.json", "w") as f:
        json.dump({"nvidia_smi": smi.strip(), "cases": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
