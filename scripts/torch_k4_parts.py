"""What bounds each part of the port's rank-prefix matvec (K4) on an NVIDIA
GPU, by cutting the part out.

    python3 scripts/torch_k4_parts.py

Times `fused_stream.fused_matvec` of the `effort_tpu_torch` package found in
the current directory at the four fused Mistral-7B projections (int8
rank-prefix values, B = 4, G = 16, effort 0.25, tau 0.97: chip_smoke.py's
K4 summary points), L2 flushed, median over 8 fresh inputs, with the device
time of each of its kernels (torch.profiler, mean of 5 calls), once as it
is and once for each variant built from an edited copy of csrc/ under
build/k4_parts/ (the results of a variant are wrong by design; only its
times mean anything):
  full    the kernels as they are
  nocomp  the stream's consumer warps skip the arithmetic: the stream's
          time is then that of moving its bytes through the ring
  noload  the stream's producer copies nothing: the stream's time is then
          that of its arithmetic
  nocut   the selection skips the cutoff search (row_prefix::find_cutoff)
Prints the card's name and power limit and one JSON line per variant,
and writes them to k4_parts.json in chip_smoke.py's output directory.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effort_tpu_torch.config import BucketConfig  # noqa: E402
from effort_tpu_torch.kernels import _build, fused_stream  # noqa: E402
from effort_tpu_torch.ops import bucketmul  # noqa: E402
from effort_tpu_torch.ops.bucketize import (bucketize,  # noqa: E402
                                            calib_row_order)
from effort_tpu_torch.ops.effort import effort_q16  # noqa: E402
from effort_tpu_torch.utils.timing import gpu_ms  # noqa: E402

RUNS = 8
PROFILED = 5
VARIANTS = {
    "full": [],
    "nocomp": [("rank_prefix.cuh", "        if (q >= nr) break;",
                "        if (q >= nr || true) break;")],
    "noload": [("rank_prefix.cuh",
                "        mbar_expect_tx(&full[slot], bytes);\n"
                "        for (int i = 0; i < nbox; ++i) {",
                "        mbar_arrive(&full[slot]);\n"
                "        for (int i = 0; i < 0; ++i) {")],
    "nocut": [("fused_matvec.cu",
               "  const float cutoff = row_prefix::find_cutoff(v, P, stride,"
               " probes, eff,\n"
               "                                               tables);",
               "  const float cutoff = eff;")],
}


def build_variant(name: str, edits: list, src: Path,
                  under: str = "k4_parts") -> None:
    """Point _build at a copy of src under build/<under>/<name> with the
    edits made."""
    d = Path("build") / under / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d / "csrc")
    for fname, old, new in edits:
        p = d / "csrc" / fname
        text = p.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
        p.write_text(text.replace(old, new))
    _build._SRC_DIR = d / "csrc"
    _build.BUILD_DIR = d / "kernels"
    _build._LIBS.clear()
    _build._FNS.clear()
    _build.build_all()


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_k4_parts: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(2468)
    cases = []
    for name, (i, o) in cs.SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        bm = bucketize(wt, BucketConfig(dtype="int8", **cs.RANK_BUCKETS),
                       in_perm=pi)
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        cases.append((name, bm, vs))
        del wt
    eq = effort_q16(0.25, "cuda")
    src = _build._SRC_DIR
    out = {"nvidia_smi": smi}
    for var, edits in VARIANTS.items():
        build_variant(var, edits, src)
        res = {}
        for name, bm, vs in cases:
            tgb = bucketmul._tile_blocks(bm)
            call = lambda v: fused_stream.fused_matvec(  # noqa: E731
                bm, v, eq, 0, tgb)
            ms = cs.median([gpu_ms(call, (v,), flush) for v in vs])
            prof = cs.device_profile(
                lambda: [call(v) for v in vs[:PROFILED]])["kernel_ms"]
            res[name] = dict(ms=ms, parts_us={
                k: t * 1e3 / PROFILED for k, t in prof.items()})
        res["sum_ms"] = sum(r["ms"] for r in res.values())
        out[var] = res
        print(json.dumps({"variant": var, **res}), flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    with open(cs.OUT_DIR / "k4_parts.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
