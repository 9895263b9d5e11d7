"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each (a failure raises and exits non-zero):
  device    the card's name, count and power limit (nvidia-smi)
  build     nvcc builds every csrc/*.cu of effort_tpu_torch
  kernels   K1 (mxu_matvec, csrc/mxu_matvec.cu) against its plain PyTorch
            version at the four fused Mistral-7B projection shapes x
            {bf16, int8, int4} x efforts {0.1, 0.25, 0.5, 1.0} x tau
            {0.97, 1.0}: equal streamed length C, cos >= 0.9999 and
            max|dy| <= 1e-2 max|y_ref|; device times beside the memory
            bound and a dense bf16 torch.mm GEMV of the same shape
  generate  Mistral-7B width, 32 layers, int8 row-prefix buckets, fused
            projections, int8 LM head: Engine.generate answers four
            requests at efforts 0.25 and 0.5 (K1) and 1.0 (dense copies);
            K1's launch count must be 4 * 32 per decode step
  profile   device time by kernel over one request, and the card's busy
            share of that request's wall time
  teacher   logits of the kernel route against the route through K1's
            plain version over one reply's tokens at tau = 1, both reading
            the same history: cos >= 0.999 at every step at depth 4;
            depth 32, and the reference route, are printed only
Then the `kernels` summary line, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. The full per-point table is written to
chiprun_out/chip_smoke.json. float32 matmuls run in full f32 (TF32 off).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from effort_tpu_torch.config import BucketConfig, mistral_7b
from effort_tpu_torch.kernels import LAUNCHES, _build, reset_launches
from effort_tpu_torch.kernels import fused_stream
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.models.transformer import (embed, forward_layers,
                                                 head_logits,
                                                 init_random_weights,
                                                 make_kv_cache,
                                                 quantize_head, rms_norm)
from effort_tpu_torch.ops.bucketize import (bucketize, calib_row_order,
                                            pick_chunk_rows)
from effort_tpu_torch.ops.bucketmul import dense_matvec
from effort_tpu_torch.ops.effort import effort_q16
from effort_tpu_torch.utils.timing import gpu_ms

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
          "w13": (4096, 28672), "w2": (14336, 4096)}
DTYPES = ("bf16", "int8", "int4")
EFFORTS = (0.1, 0.25, 0.5, 1.0)
TAUS = (0.97, 1.0)
RUNS = 20
# the summary line's times: one layer's four launches of the generate
# phase's layout (int8) at effort 0.25 and the default tau
SUMMARY = ("int8", 0.25, 0.97)
PROMPT_LENS = (5, 17, 32, 64)
N_NEW = 32
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=0))


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(built), "libraries": {
              k: str(p.relative_to(p.parents[2]))
              for k, p in _build.library_paths().items()}})


def k1_bytes(bm, C: int) -> int:
    """Bytes K1 must move: the streamed prefix of the values, v, probes,
    stats and scales once each, y written once."""
    row_bytes = bm.vals.shape[2] * bm.vals.element_size()
    streamed = C * bm.chunk_rows * row_bytes
    per_row = 4 * (2 + (bm.scales is not None))       # v, stats, scales
    return (streamed + bm.in_dim * per_row + bm.probes.shape[1] * 4
            + bm.n_buckets * 4)


def phase_kernels(flush: torch.Tensor) -> list:
    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    points = []
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt[pi.long()].to(torch.bfloat16)
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        vb = [v.to(torch.bfloat16)[None] for v in vs]
        lib_ms = median([gpu_ms(lambda a: torch.mm(a, dense), (a,), flush)
                         for a in vb])
        del dense
        for dtype in DTYPES:
            bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype)
            bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
            bm = bucketize(wt, bc, in_perm=pi)
            for effort in EFFORTS:
                eq = effort_q16(effort, "cuda")
                for tau in TAUS:
                    y, C = fused_stream.mxu_matvec(bm, vs[0], eq, 0, tau=tau,
                                                   return_len=True)
                    yr, Cr = fused_stream.mxu_matvec_ref(
                        bm, vs[0], eq, 0, tau=tau, return_len=True)
                    torch.cuda.synchronize()
                    C, Cr = int(C), int(Cr)
                    err = float((y - yr).abs().max())
                    scale = float(yr.abs().max())
                    c = cos(y, yr)
                    p = dict(shape=name, in_dim=i, out_dim=o, dtype=dtype,
                             chunk_rows=bm.chunk_rows, n_chunks=bm.n_chunks,
                             effort=effort, tau=tau, C=C, C_plain=Cr,
                             cos=c, max_abs_err=err, max_abs_ref=scale)
                    if C != Cr or not c >= 0.9999 or not err <= 1e-2 * scale:
                        raise AssertionError(f"K1 disagrees with its plain "
                                             f"version: {p}")
                    p["ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec(bm, v, eq, 0,
                                                          tau=tau),
                        (v,), flush) for v in vs])
                    p["plain_ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec_ref(bm, v, eq, 0,
                                                              tau=tau),
                        (v,), flush) for v in vs])
                    p["bytes"] = k1_bytes(bm, C)
                    p["bound_ms"] = p["bytes"] / HBM_BYTES_PER_S * 1e3
                    p["library_ms"] = lib_ms
                    points.append(p)
                    emit({"phase": "kernels", **p})
            del bm
        del wt, vs, vb
        torch.cuda.empty_cache()
    return points


def phase_generate():
    cfg = mistral_7b(n_layers=32, max_seq_len=512)
    bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(cfg, bcfg, seed=0, calibrate=True,
                                          fuse=True, keep_dense=True,
                                          device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "generate_setup", "seconds": time.perf_counter() - t0,
          "weights_gib": torch.cuda.memory_allocated() / 2**30})
    eng = Engine(w, cfg, eos_id=-1)
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PROMPT_LENS]
    steps = sum(max(eng.pad_to, -(-n // eng.pad_to) * eng.pad_to)
                + N_NEW - 1 for n in PROMPT_LENS)
    eng.generate(prompts[0], n_new=2, effort=0.25)       # warm-up
    results, replies = [], {}
    torch.cuda.synchronize()
    reset_launches()                    # the main path's run starts here
    for effort in (0.25, 0.5, 1.0):
        before = LAUNCHES["mxu_matvec"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = [eng.generate(p, n_new=N_NEW, effort=effort) for p in prompts]
        end.record()
        end.synchronize()
        launches = LAUNCHES["mxu_matvec"] - before
        ms = start.elapsed_time(end)
        want = 4 * cfg.n_layers * steps if effort < 0.999 else 0
        r = dict(effort=effort, requests=len(prompts), steps=steps,
                 ms=ms, ms_per_token=ms / steps, launches=launches,
                 launches_expected=want, first_tokens=out[0].token_ids[:8])
        results.append(r)
        emit({"phase": "generate", **r})
        for rep in out:
            if len(rep.token_ids) != N_NEW or not all(
                    0 <= t < cfg.vocab_size for t in rep.token_ids):
                raise AssertionError(f"bad reply at effort {effort}: "
                                     f"{rep.token_ids}")
        if launches != want:
            raise AssertionError(f"K1 launched {launches} times at effort "
                                 f"{effort}, expected {want}")
        replies[effort] = out
    total = LAUNCHES["mxu_matvec"]      # ... and is read here
    if total == 0 or total != sum(r["launches"] for r in results):
        raise AssertionError(f"K1 launches in the main path's run: {total}")
    return cfg, w, eng, prompts, replies, results


def phase_profile(eng, prompt) -> dict:
    """Where one request's time goes: device time by kernel (torch.profiler)
    over one request of 8 new tokens at effort 0.25, against the wall time
    of the same request run again without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_new = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompt, n_new=n_new, effort=0.25)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompt, n_new=n_new, effort=0.25)
    wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's row repeats the time of its kernels
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    # K1's three kernels live in an anonymous namespace of mxu_matvec.cu
    # (torch's own reductions are named reduce_kernel too)
    k1 = {part: sum(k[1] for k in kernels if f"namespace)::{part}" in k[0])
          for part in ("select_kernel", "stream_kernel", "reduce_kernel")}
    steps = max(eng.pad_to, -(-len(prompt) // eng.pad_to) * eng.pad_to) \
        + n_new - 1
    r = dict(steps=steps, wall_ms=wall_ms, device_ms=device_ms,
             device_busy_share=device_ms / wall_ms,
             k1_ms=k1, top=[(name[:60], ms, n) for name, ms, n in kernels[:8]])
    emit({"phase": "profile", **r})
    return r


def phase_teacher(cfg, w, tokens) -> list:
    """The kernel route against the kernel's plain version ("plain") and
    against the reference route, at tau = 1, over the same tokens. At every
    step all routes read the same history (the kernel route's KV cache; the
    others run on copies), so the logits differ only by this step's layers.

    Required: kernel vs plain, cos >= 0.999 at every step at depth 4. The
    reference route is another function: it keeps u in f32 where the
    kernel rounds u to bf16, and searches its cutoff with 0.62**j instead
    of the kernel's exp table; the discrete row selection turns those
    last-bit differences into whole rows at low effort, so its cosine is
    printed, not required. Cosines are of logits through the exact bf16
    head (the int8 head rounds h to 255 levels per tensor, so a last-bit
    change in h moves whole rounding steps outside its rescored top 16);
    the int8 head's cosine and argmax agreement are printed beside them."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    rows = []

    def h_final(cfg_d, tok, pos, kv, eq, impl):
        h = forward_layers(w, cfg_d, embed(w, tok), pos, *kv, effort=eq,
                           impl=impl)
        return rms_norm(h, w.norm, cfg.norm_eps)

    try:
        for depth in (4, 32):
            cfg_d = dataclasses.replace(cfg, n_layers=depth)
            for effort in (0.25, 0.5):
                eq = effort_q16(effort, "cuda")
                kv = make_kv_cache(cfg_d, "cuda")
                c = {k: [] for k in ("plain", "plain_int8", "reference")}
                agree, finite = 0, True
                for pos, tok in enumerate(tokens):
                    h = {impl: h_final(cfg_d, tok, pos,
                                       tuple(x.clone() for x in kv),
                                       eq, impl)
                         for impl in ("plain", "reference")}
                    h["kernel"] = h_final(cfg_d, tok, pos, kv, eq, "kernel")
                    exact = {k: dense_matvec(x, w.output)
                             for k, x in h.items()}
                    lk, lp = head_logits(w, h["kernel"]), head_logits(
                        w, h["plain"])
                    finite &= bool(torch.isfinite(lk).all())
                    c["plain"].append(cos(exact["kernel"], exact["plain"]))
                    c["plain_int8"].append(cos(lk, lp))
                    c["reference"].append(cos(exact["kernel"],
                                              exact["reference"]))
                    agree += int(lk.argmax() == lp.argmax())
                n = len(tokens)
                r = dict(depth=depth, effort=effort, steps=n,
                         min_cos_plain=min(c["plain"]),
                         mean_cos_plain=sum(c["plain"]) / n,
                         min_cos_plain_int8_head=min(c["plain_int8"]),
                         argmax_agreement_plain=agree / n,
                         min_cos_reference=min(c["reference"]),
                         mean_cos_reference=sum(c["reference"]) / n,
                         finite=finite, required=depth == 4)
                rows.append(r)
                emit({"phase": "teacher", **r})
                if not finite or (depth == 4
                                  and not r["min_cos_plain"] >= 0.999):
                    raise AssertionError(f"kernel route vs plain: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    points = phase_kernels(flush)
    del flush
    torch.cuda.empty_cache()
    cfg, w, eng, prompts, replies, gen = phase_generate()
    profiled = phase_profile(eng, prompts[0])
    teacher = phase_teacher(cfg, w, prompts[0] + replies[0.25][0].token_ids)

    summary = [p for p in points
               if (p["dtype"], p["effort"], p["tau"]) == SUMMARY]
    k1 = {"name": "mxu_matvec", "route": "cuda",
          "source": "effort_tpu_torch/csrc/mxu_matvec.cu",
          "replaces": "effort_tpu/kernels/fused_stream.py:270",
          "launches": sum(r["launches"] for r in gen),
          "max_abs_err": max(p["max_abs_err"] for p in points),
          "ms": sum(p["ms"] for p in summary),
          "plain_ms": sum(p["plain_ms"] for p in summary),
          "bound_ms": sum(p["bound_ms"] for p in summary),
          "bound_by": "bytes",
          "library_ms": sum(p["library_ms"] for p in summary)}
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "k1": k1,
                   "points": points, "generate": gen, "profile": profiled,
                   "teacher": teacher,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [k1]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
