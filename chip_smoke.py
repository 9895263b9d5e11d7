"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each (a failure raises and exits non-zero):
  device    the card's name, count and power limit (nvidia-smi)
  build     nvcc builds every csrc/*.cu of effort_tpu_torch, in parallel
  kernels   K1 (mxu_matvec, csrc/mxu_matvec.cu) against its plain PyTorch
            version at the four fused Mistral-7B projection shapes x
            {bf16, int8, int4} x efforts {0.1, 0.25, 0.5, 1.0} x tau
            {0.97, 1.0}: equal streamed length C, cos >= 0.9999 and
            max|dy| <= 1e-2 max|y_ref|; device times beside the memory
            bound and a dense bf16 torch.mm GEMV of the same shape
  kernels_batch
            K2 (mxu_matvec_batch, csrc/mxu_matvec_batch.cu) likewise at
            the four shapes x {bf16, int8, int4} x T in {4, 64} slots x
            tau {0.97, 1.0}, and int8 at tau 0.97 with T in {16, 256}
            (where the bound turns from bytes to operations), per-slot
            efforts 0.1/0.25/0.5/1.0 repeated with the last slot at 0:
            equal C, cos >= 0.9999 per slot, max|dy| <= 1e-2 max|y_ref|;
            times beside the bound (bytes, or bf16 operations where they
            weigh more) and a dense bf16 torch.mm [T, in] @ [in, out];
            at int8, tau 0.97 the device time of one call by kernel
            (selection, stream, split sum)
  attention K3 (flash_attention, csrc/flash_attention.cu) against its plain
            version at Mistral-7B's heads (32 query, 8 KV, 128 wide) over
            a 512-slot cache: left-padded prompts of 32 and 64 queries, 64
            queries at slot 448, and a 128-slot window; cos >= 0.9999 per
            row, max|dy| <= 1e-2 max|y_ref|, queries with no live key
            exactly 0; times beside the bound and torch's SDPA with the
            same boolean mask (timed only, never called by the port)
  generate  Mistral-7B width, 32 layers, int8 row-prefix buckets, fused
            projections, int8 LM head: Engine.generate answers four
            requests at efforts 0.25 and 0.5 (K1) and 1.0 (dense copies);
            K1's launch count must be 4 * 32 per decode step, K2's and
            K3's 0
  profile   device time by kernel over one request, and the card's busy
            share of that request's wall time
  teacher   logits of the kernel route against the route through K1's
            plain version over one reply's tokens at tau = 1, both reading
            the same history: cos >= 0.999 at every step at depth 4;
            depth 32 (over the first 13 steps), and the reference route,
            are printed only
  prefill   the same model, Engine(prefill=True): the four prompts at
            efforts 0.25, 0.5 and 1.0; time to first token and decode ms
            per token; per call K3 must run 32 times, K2 4 * 32 times
            below effort 1 (0 at 1: dense copies) and K1 4 * 32 times a
            decode step below effort 1; beside it the token-loop engine's
            time to first token on the same prompts; then device time by
            kernel over one prefill call (64 tokens, effort 0.25)
  prefill_teacher
            forward_seq at tau = 1 over a left-padded prompt: the kernel
            route (K2, K3) against the plain route, and dense forward_seq
            against dense forward_token steps, cos >= 0.999 at every
            position at depth 4; depth 32 printed only, beside two
            witnesses: at each of the 32 layers K2 and K3 against their
            plain versions on the inputs the kernel route gave them (cos
            >= 0.9999, equal C), and the plain route against itself with
            the attention-norm weights moved by a relative 2^-20 (printed)
  serve     BatchEngine(batch_size=4) + ContinuousBatcher: 8 requests
            (prompts of 5 to 64 tokens, efforts 0.25/0.5/1.0, 32 new
            tokens each) through 4 slots; aggregate tokens/s; K2 must run
            4 * 32 times a decode step and an admission, K3 32 times an
            admission, K1 never. Then device time by kernel over four
            8-token requests, one batched step against the
            single-stream K1 route at depth 4, tau = 1 (cos >= 0.999 per
            slot), and make_batch_server on 127.0.0.1 answering four
            concurrent /q, one stream=1 and one /v1/completions
  kernels_rank
            K4 (fused_matvec, csrc/fused_matvec.cu) and K5 (stream_matvec,
            csrc/stream_matvec.cu) against their plain versions at the four
            shapes x {bf16, int8, int4} x efforts {0.1, 0.25, 0.5} x tau
            {0.97, 1.0}, rank-prefix buckets B = 4, G = 16: equal C_k per
            rank, cos >= 0.9999, max|dy| <= 1e-2 max|y_ref|, and y equal
            bit for bit (the plain versions add in the kernels' order); K5
            on K4's own selection equals K4 to 1e-5; at int8, effort 0.25,
            tau 0.97 the device time of one K4 call by kernel (selection,
            stream, split sum); K6 (gather_matvec_dma, csrc/gather_dma.cu)
            and K7 (gather_bucket_matvec, csrc/gather_mul.cu) likewise at
            {bf16, int8} x the efforts at the gather route's capacity, y
            bit for bit and K7 equal to K6; times beside the bound and the
            dense bf16 torch.mm GEMV (K6's and K7's `kernels` entries also
            give each projection's ms)
  rank_decode
            the row-prefix model freed, Mistral-7B width and depth with int8
            rank-prefix buckets (B = 4, G = 16), fused projections, int8 LM
            head, no dense copies: Engine.generate on the four prompts at
            efforts 0.25, 0.5 and 1.0 through "auto" (K4 only, 4 * 32
            launches a step), a few tokens through "stream" (K5 only) and
            "gather" (K6 only) at 8-slot padding, and the "gather" route's
            device time by kernel over two tokens; device time by kernel
            over one request;
            every layer's K4 call against its plain version on the same
            inputs at depth 32 (cos >= 0.9999, equal C_k); the kernel route
            against the plain route at tau = 1, depth 4, over a prompt and
            8 reply tokens (cos >= 0.999); and
            make_server (single flight) answering /q on this model
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
from effort_tpu_torch.kernels import (fused_stream, gather_dma, gather_mul,
                                      prefix_stream)
from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
from effort_tpu_torch.models import transformer
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.ops import bucketmul
from effort_tpu_torch.models.transformer import (embed, forward_layers,
                                                 forward_seq, forward_token,
                                                 forward_token_batch,
                                                 head_logits,
                                                 init_random_weights,
                                                 make_kv_cache,
                                                 quantize_head, rms_norm)
from effort_tpu_torch.ops.bucketize import (bucketize, calib_row_order,
                                            pick_chunk_rows)
from effort_tpu_torch.ops.bucketmul import dense_matvec
from effort_tpu_torch.ops.effort import effort_q16, select_blocks
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from effort_tpu_torch.serving.server import make_batch_server, make_server
from effort_tpu_torch.utils.timing import gpu_ms

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak, same sheet
SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096),
          "w13": (4096, 28672), "w2": (14336, 4096)}
DTYPES = ("bf16", "int8", "int4")
EFFORTS = (0.1, 0.25, 0.5, 1.0)
TAUS = (0.97, 1.0)
RUNS = 20
PLAIN_RUNS = 3                     # K4-K7's plain versions, timed only
# the teacher phase's printed depth-32 witness runs over the first steps
# only (a 5-token prompt and 8 reply tokens), to keep the run's time
DEEP_TEACHER_STEPS = 13
# K2's points: (T, value kinds, taus); T = 4 batched decode slots, 64
# prefill tokens, 16 and 256 either side of where the bound turns from
# bytes to operations
BATCH_CASES = ((4, DTYPES, TAUS), (64, DTYPES, TAUS), (16, ("int8",), (0.97,)),
               (256, ("int8",), (0.97,)))
ATTN_CASES = (
    dict(name="prefill32", T=32, start_slot=0, mask_from=27, window=0),
    dict(name="prefill64", T=64, start_slot=0, mask_from=47, window=0),
    dict(name="chunk64_at448", T=64, start_slot=448, mask_from=0, window=0),
    dict(name="window128", T=64, start_slot=448, mask_from=0, window=128),
)
# the summary line's times: one layer's four launches of the generate
# phase's layout (int8) at effort 0.25 and the default tau
SUMMARY = ("int8", 0.25, 0.97)
# K2's: one prefill layer's four launches (int8, T = 64, default tau), and
# beside it one batched decode step's (T = 4, the "_t4" keys); K3's: one
# prefill call at T = 64
SUMMARY_BATCH = ("int8", 64, 0.97)
SUMMARY_BATCH_T4 = ("int8", 4, 0.97)
PROFILE_CALLS = 5
SUMMARY_ATTN = "prefill64"
# rank-prefix buckets of the K4-K7 points and the rank_decode model
RANK_BUCKETS = dict(bucket_size=4, chunk_rows=16)
RANK_EFFORTS = (0.1, 0.25, 0.5)
# K4's and K5's summary: one decode layer's four launches (int8, effort
# 0.25, default tau); K6's and K7's: the same at effort 0.25
SUMMARY_RANK = ("int8", 0.25, 0.97)
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


def padded(n: int, pad_to: int = 32) -> int:
    return max(pad_to, -(-n // pad_to) * pad_to)


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


def k2_bytes(bm, C: int, T: int) -> int:
    """Bytes K2 must move: the streamed prefix once (shared by the T
    slots), V, probes, stats and scales once each, Y written once."""
    row_bytes = bm.vals.shape[2] * bm.vals.element_size()
    per_row = 4 * (1 + (bm.scales is not None)) + 4 * T   # stats, scales, V
    return (C * bm.chunk_rows * row_bytes + bm.in_dim * per_row
            + bm.probes.shape[1] * 4 + T * bm.n_buckets * 4)


def batch_efforts(T: int) -> torch.Tensor:
    """0.1 / 0.25 / 0.5 / 1.0 repeated over the slots, the last slot at 0."""
    e = [EFFORTS[t % len(EFFORTS)] for t in range(T)]
    e[-1] = 0.0
    return torch.tensor(e, dtype=torch.float32, device="cuda")


def rows_agree(y: torch.Tensor, yr: torch.Tensor) -> float:
    """The least cosine over rows; a row that is 0 in the plain version
    must be exactly 0 in the kernel's output (counted as cosine 1)."""
    worst = 1.0
    for a, b in zip(y, yr):
        if not bool(b.any()):
            if bool(a.any()):
                return 0.0
            continue
        worst = min(worst, cos(a, b))
    return worst


def phase_kernels_batch(flush: torch.Tensor) -> list:
    """K2 against its plain version at BATCH_CASES over the four fused
    projections, with mixed per-slot efforts."""
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    points = []
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt[pi.long()].to(torch.bfloat16)
        Ts = [case[0] for case in BATCH_CASES]
        Vs = {T: [rms[pi.long()] * torch.randn((T, i), generator=g,
                                               device="cuda")
                  for _ in range(RUNS)] for T in Ts}
        lib_ms = {T: median([gpu_ms(lambda a: torch.mm(a, dense),
                                    (V.to(torch.bfloat16),), flush)
                             for V in Vs[T]]) for T in Ts}
        del dense
        for dtype in DTYPES:
            bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype)
            bc = dataclasses.replace(bc, chunk_rows=pick_chunk_rows(bc, i, o))
            bm = bucketize(wt, bc, in_perm=pi)
            for T, dtypes, taus in BATCH_CASES:
                if dtype not in dtypes:
                    continue
                eff = batch_efforts(T)
                for tau in taus:
                    V = Vs[T][0]
                    y, C = fused_stream.mxu_matvec_batch(
                        bm, V, eff, 0, tau=tau, return_len=True)
                    yr, Cr = fused_stream.mxu_matvec_batch_ref(
                        bm, V, eff, 0, tau=tau, return_len=True)
                    torch.cuda.synchronize()
                    C, Cr = int(C), int(Cr)
                    err = float((y - yr).abs().max())
                    scale = float(yr.abs().max())
                    c = rows_agree(y, yr)
                    p = dict(shape=name, in_dim=i, out_dim=o, dtype=dtype,
                             T=T, chunk_rows=bm.chunk_rows,
                             n_chunks=bm.n_chunks, tau=tau, C=C, C_plain=Cr,
                             min_slot_cos=c, max_abs_err=err,
                             max_abs_ref=scale)
                    if C != Cr or not c >= 0.9999 or not err <= 1e-2 * scale:
                        raise AssertionError(f"K2 disagrees with its plain "
                                             f"version: {p}")
                    p["ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec_batch(
                            bm, v, eff, 0, tau=tau), (v,), flush)
                        for v in Vs[T]])
                    p["plain_ms"] = median([gpu_ms(
                        lambda v: fused_stream.mxu_matvec_batch_ref(
                            bm, v, eff, 0, tau=tau), (v,), flush)
                        for v in Vs[T]])
                    p["bytes"] = k2_bytes(bm, C, T)
                    p["flops"] = 2 * T * C * bm.chunk_rows * o
                    bytes_ms = p["bytes"] / HBM_BYTES_PER_S * 1e3
                    flops_ms = p["flops"] / BF16_FLOPS * 1e3
                    p["bound_ms"] = max(bytes_ms, flops_ms)
                    p["bound_by"] = ("bytes" if bytes_ms >= flops_ms
                                     else "operations")
                    p["library_ms"] = lib_ms[T]
                    if (dtype, tau) == (SUMMARY_BATCH[0], SUMMARY_BATCH[2]):
                        # where a call's device time goes (selection,
                        # stream, split sum): the mean over PROFILE_CALLS
                        # calls, as one short call's trace can come back
                        # empty
                        prof = device_profile(lambda: [
                            fused_stream.mxu_matvec_batch(bm, v, eff, 0,
                                                          tau=tau)
                            for v in Vs[T][:PROFILE_CALLS]])["kernel_ms"]
                        p["parts_ms"] = {k: ms / PROFILE_CALLS
                                         for k, ms in prof.items()}
                    points.append(p)
                    emit({"phase": "kernels_batch", **p})
            del bm
        del wt, Vs
        torch.cuda.empty_cache()
    return points


def phase_attention(flush: torch.Tensor) -> list:
    """K3 against its plain version at Mistral-7B's heads (H 32, KV 8,
    D 128) over a 512-slot cache, in the forward_seq layout. Times are
    taken with L2 flushed, as K1's and K2's are."""
    H, KV, D, S = 32, 8, 128, 512
    g = torch.Generator(device="cuda")
    g.manual_seed(99)
    points = []
    for case in ATTN_CASES:
        T, start, mf, win = (case["T"], case["start_slot"],
                             case["mask_from"], case["window"])
        kc = torch.randn((S, KV, D), generator=g, device="cuda").to(
            torch.bfloat16)
        vc = torch.randn((S, KV, D), generator=g, device="cuda").to(
            torch.bfloat16)
        Qs = [torch.randn((T, H * D), generator=g, device="cuda") * 2.0
              for _ in range(RUNS)]

        def run(q, plain=False):
            return flash_attention_seq(q, kc, vc, start, mf, H, D,
                                       window=win, plain=plain)
        y, yr = run(Qs[0]), run(Qs[0], plain=True)
        torch.cuda.synchronize()
        slot = start + torch.arange(T, device="cuda")
        dead = slot < mf                    # queries with no live key
        rows, rows_r = y.reshape(T * H, D), yr.reshape(T * H, D)
        live_rows = (~dead).repeat_interleave(H)
        c = rows_agree(rows[live_rows], rows_r[live_rows])
        err = float((y - yr).abs().max())
        scale = float(yr.abs().max())
        dead_zero = not bool(y[dead].any())
        p = dict(case=case["name"], T=T, S=S, H=H, KV=KV, D=D,
                 start_slot=start, mask_from=mf, window=win,
                 dead_rows=int(dead.sum()), min_row_cos=c,
                 max_abs_err=err, max_abs_ref=scale,
                 dead_rows_zero=dead_zero)
        if not c >= 0.9999 or not err <= 1e-2 * scale or not dead_zero:
            raise AssertionError(f"K3 disagrees with its plain version: {p}")
        # the live keys of each query, for the bound
        k_ids = torch.arange(S, device="cuda")
        live = (k_ids[None] <= slot[:, None]) & (k_ids[None] >= mf)
        if win:
            live &= k_ids[None] > slot[:, None] - win
        n_live = int(live.sum())
        keys = int(live.any(dim=0).sum())
        p["bytes"] = 2 * T * H * D * 4 + 2 * keys * KV * D * 2
        p["flops"] = 4 * H * D * n_live
        bytes_ms = p["bytes"] / HBM_BYTES_PER_S * 1e3
        flops_ms = p["flops"] / BF16_FLOPS * 1e3
        p["bound_ms"] = max(bytes_ms, flops_ms)
        p["bound_by"] = "bytes" if bytes_ms >= flops_ms else "operations"
        p["ms"] = median([gpu_ms(run, (q,), flush) for q in Qs])
        p["plain_ms"] = median([gpu_ms(lambda q: run(q, True), (q,), flush)
                                for q in Qs])
        # yardstick only: torch's SDPA with the same boolean mask
        kf = kc.permute(1, 0, 2).repeat_interleave(H // KV, 0)[None]
        vf = vc.permute(1, 0, 2).repeat_interleave(H // KV, 0)[None]
        qb = [q.reshape(T, H, D).permute(1, 0, 2)[None].to(torch.bfloat16)
              for q in Qs]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        p["library_ms"] = median([gpu_ms(
            lambda q: sdpa(q, kf, vf, attn_mask=live), (q,), flush)
            for q in qb])
        points.append(p)
        emit({"phase": "attention", **p})
    return points


def build_model():
    """Mistral-7B width and depth, int8 row-prefix buckets, fused wqkv and
    w13, int8 LM head, dense copies kept; random calibrated weights from
    seed 0. Returns (cfg, w, engine, prompts); every model phase uses it."""
    cfg = mistral_7b(n_layers=32, max_seq_len=512)
    bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(cfg, bcfg, seed=0, calibrate=True,
                                          fuse=True, keep_dense=True,
                                          device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "model_setup", "seconds": time.perf_counter() - t0,
          "weights_gib": torch.cuda.memory_allocated() / 2**30})
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PROMPT_LENS]
    return cfg, w, Engine(w, cfg, eos_id=-1), prompts


def check_replies(replies, cfg, n_new: int, what: str) -> None:
    for toks in replies:
        if len(toks) != n_new or not all(0 <= t < cfg.vocab_size
                                         for t in toks):
            raise AssertionError(f"bad reply ({what}): {toks}")


def check_launches(got: dict, want: dict, what: str) -> None:
    """Every kernel's count in one run of a path against the count the path
    must give (kernels the path must not reach are given as 0)."""
    bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    if bad:
        raise AssertionError(f"launches (got, expected) in {what}: {bad}")


def phase_generate(cfg, w, eng, prompts):
    """Single-stream decode, the prompt fed token by token (K1)."""
    steps = sum(padded(n, eng.pad_to) + N_NEW - 1 for n in PROMPT_LENS)
    eng.generate(prompts[0], n_new=2, effort=0.25)       # warm-up
    results, replies = [], {}
    for effort in (0.25, 0.5, 1.0):
        torch.cuda.synchronize()
        reset_launches()                # the path's run starts here ...
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = [eng.generate(p, n_new=N_NEW, effort=effort) for p in prompts]
        end.record()
        end.synchronize()
        launches = dict(LAUNCHES)       # ... and is read here
        ms = start.elapsed_time(end)
        want = 4 * cfg.n_layers * steps if effort < 0.999 else 0
        r = dict(effort=effort, requests=len(prompts), steps=steps,
                 ms=ms, ms_per_token=ms / steps, launches=launches,
                 first_tokens=out[0].token_ids[:8])
        results.append(r)
        emit({"phase": "generate", **r})
        check_replies([rep.token_ids for rep in out], cfg, N_NEW,
                      f"generate, effort {effort}")
        check_launches(launches, {"mxu_matvec": want, "mxu_matvec_batch": 0,
                                  "flash_attention": 0},
                       f"generate at effort {effort}")
        replies[effort] = out
    if not sum(r["launches"]["mxu_matvec"] for r in results):
        raise AssertionError("K1 was not launched on the decode path")
    return results, replies


# the ported kernels' own CUDA kernels, by a part of their profiler names
# (K1's and K2's live in anonymous namespaces; torch's own reductions are
# named reduce_kernel too)
KERNEL_PARTS = {"k1_select": "namespace)::select_kernel",
                "k1_stream": "namespace)::stream_kernel",
                "k1_reduce": "namespace)::reduce_kernel",
                "k2_select": "namespace)::select_batch_kernel",
                "k2_stream": "namespace)::mma_stream_kernel",
                "k2_reduce": "namespace)::reduce_batch_kernel",
                "k3": "namespace)::flash_kernel",
                "k4_select": "namespace)::grid_select_kernel",
                "k4_k5_stream": "rank_prefix::ring_stream_kernel",
                "split_sum": "rank_prefix::reduce_splits",    # K4-K7's
                "k6_k7_gather": "block_gather::ring_gather_kernel"}


def device_profile(fn) -> dict:
    """Where the time of fn() goes: device time by kernel (torch.profiler,
    device activity only, summed over the raw trace events: host events
    and the profiler's own event tree cost the run tens of seconds a pass
    and add nothing to these sums) against the wall time of fn() run again
    without the profiler; the card's busy share is their ratio."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    kernels = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                     key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    parts = {part: sum(k[1] for k in kernels if sub in k[0])
             for part, sub in KERNEL_PARTS.items()}
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                kernel_ms={k: v for k, v in parts.items() if v},
                top=[(name[:60], ms, n) for name, ms, n in kernels[:8]])


def phase_profile(eng, prompt) -> dict:
    """Where one request's time goes: one request of 8 new tokens at
    effort 0.25 on the token-loop engine."""
    n_new = 8
    r = dict(steps=padded(len(prompt), eng.pad_to) + n_new - 1,
             **device_profile(lambda: eng.generate(prompt, n_new=n_new,
                                                   effort=0.25)))
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
            steps = tokens if depth == 4 else tokens[:DEEP_TEACHER_STEPS]
            for effort in (0.25, 0.5):
                eq = effort_q16(effort, "cuda")
                kv = make_kv_cache(cfg_d, "cuda")
                c = {k: [] for k in ("plain", "plain_int8", "reference")}
                agree, finite = 0, True
                for pos, tok in enumerate(steps):
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
                n = len(steps)
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


def phase_prefill(cfg, w, eng, prompts) -> list:
    """Engine(prefill=True): each prompt runs through one forward_seq pass
    (K2 per projection below effort 1, dense copies at 1; K3 per layer),
    then greedy decode (K1). Time to first token: the wall time of a call
    asking for one token (the reply read back on the host included);
    decode ms per token: the rest of a 32-token call over its 31 steps."""
    pre = Engine(w, cfg, eos_id=-1, prefill=True)
    pre.generate(prompts[0], n_new=2, effort=0.25)       # warm-up
    L, results = cfg.n_layers, []
    for effort in (0.25, 0.5, 1.0):
        ttft, decode, replies = {}, [], []
        torch.cuda.synchronize()
        reset_launches()                # the path's run starts here ...
        for p in prompts:
            t0 = time.perf_counter()
            first = pre.generate(p, n_new=1, effort=effort).token_ids
            t1 = time.perf_counter()
            rep = pre.generate(p, n_new=N_NEW, effort=effort).token_ids
            t2 = time.perf_counter()
            ttft.setdefault(padded(len(p)), []).append((t1 - t0) * 1e3)
            decode.append(((t2 - t1) - (t1 - t0)) * 1e3 / (N_NEW - 1))
            replies.append(rep)
            if rep[:1] != first:
                raise AssertionError(f"prefill's first token differs "
                                     f"between two calls: {first} {rep}")
        launches = dict(LAUNCHES)       # ... and is read here
        calls, low = 2 * len(prompts), effort < 0.999
        r = dict(effort=effort, requests=len(prompts),
                 ttft_ms={P: median(v) for P, v in ttft.items()},
                 ttft_ms_all={P: v for P, v in ttft.items()},
                 decode_ms_per_token=median(decode), launches=launches,
                 first_tokens=replies[0][:8])
        results.append(r)
        emit({"phase": "prefill", **r})
        check_replies(replies, cfg, N_NEW, f"prefill, effort {effort}")
        check_launches(launches, {
            "flash_attention": L * calls,
            "mxu_matvec_batch": 4 * L * calls if low else 0,
            "mxu_matvec": 4 * L * len(prompts) * (N_NEW - 1) if low else 0},
            f"prefill at effort {effort}")
        # beside it, the token-loop engine's time to first token on the
        # same prompts (every prompt slot one decode step)
        loop = {}
        for p in prompts:
            t0 = time.perf_counter()
            eng.generate(p, n_new=1, effort=effort)
            loop.setdefault(padded(len(p)), []).append(
                (time.perf_counter() - t0) * 1e3)
        r["ttft_token_loop_ms"] = {P: median(v) for P, v in loop.items()}
        emit({"phase": "prefill_vs_token_loop", "effort": effort,
              "ttft_ms": r["ttft_ms"],
              "ttft_token_loop_ms": r["ttft_token_loop_ms"]})
    # where the time to first token goes: the 64-token prompt at 0.25
    prof = device_profile(lambda: pre.generate(prompts[-1], n_new=1,
                                               effort=0.25))
    emit({"phase": "prefill_profile", "prompt_len": len(prompts[-1]),
          **prof})
    results[0]["profile"] = prof
    return results


def min_row_cos(y: torch.Tensor, yr: torch.Tensor) -> torch.Tensor:
    """rows_agree on the device, with no wait: the least cosine over rows
    as a scalar tensor; a row that is 0 in yr counts 1 if it is 0 in y
    too, else 0."""
    y, yr = y.double(), yr.double()
    c = torch.nn.functional.cosine_similarity(y, yr, dim=-1)
    zero_ok = torch.where(y.abs().amax(-1) > 0, 0.0, 1.0).double()
    return torch.where(yr.abs().amax(-1) > 0, c, zero_ok).min()


def same_input_layers(seq, cfg_d, eff) -> dict:
    """One kernel-route pass of forward_seq in which every K2 and K3 call is
    also run through its plain version on the very inputs it was given: per
    layer, the least row cosine of its K2 calls and of its K3 call, and
    whether each K2 call's C equals the plain version's. A fault that shows
    only at later layers (a stale or strided cache read) shows here."""
    k2, k3 = bucketmul.mxu_matvec_batch, transformer.flash_attention_seq
    k2_cos, k2_c, k3_cos = [], [], []
    D = cfg_d.head_dim

    def k2_both(bm, V, efforts, expert=0, tau=None):
        y, C = k2(bm, V, efforts, expert, tau, return_len=True)
        yr, Cr = fused_stream.mxu_matvec_batch_ref(bm, V, efforts, expert,
                                                   tau, return_len=True)
        k2_cos.append(min_row_cos(y, yr))
        k2_c.append((C == Cr).all())
        return y

    def k3_both(*args, **kw):
        y = k3(*args, **kw)
        yr = k3(*args, **{**kw, "plain": True})
        k3_cos.append(min_row_cos(y.reshape(-1, D), yr.reshape(-1, D)))
        return y

    bucketmul.mxu_matvec_batch = k2_both
    transformer.flash_attention_seq = k3_both
    try:
        seq(cfg_d, eff, "kernel", "flash")
    finally:
        bucketmul.mxu_matvec_batch, transformer.flash_attention_seq = k2, k3
    L = cfg_d.n_layers
    if len(k2_cos) != 4 * L or len(k3_cos) != L:
        raise AssertionError(f"{len(k2_cos)} K2 and {len(k3_cos)} K3 calls "
                             f"in {L} layers")
    return dict(k2_min_cos=torch.stack(k2_cos).reshape(L, 4).amin(1).tolist(),
                k2_c_equal=torch.stack(k2_c).reshape(L, 4).all(1).tolist(),
                k3_min_cos=torch.stack(k3_cos).tolist())


def phase_prefill_teacher(cfg, w, eng, prompts) -> list:
    """forward_seq over one left-padded prompt (17 tokens in 32 slots) at
    tau = 1: the kernel route (K2, K3) against the plain route (both plain
    versions), and the dense forward_seq against dense forward_token steps
    over the same tokens, by the cosine of each real position's logits
    (exact bf16 head). Required at depth 4: >= 0.999 everywhere; depth 32
    is printed only. Two witnesses of why depth 32 parts: every layer's K2
    and K3 calls against their plain versions on the same inputs (required:
    cos >= 0.9999, equal C, at each of the 32 layers), and the plain route
    against itself with each attention-norm weight moved by a relative
    2^-20 x N(0, 1), about 16 f32 ulps (printed only)."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    prompt = prompts[1]
    P = padded(len(prompt))
    off = P - len(prompt)
    ids = torch.tensor([0] * off + prompt, dtype=torch.int32, device="cuda")
    rows = []
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    nudge = torch.randn(w.layers.attn_norm.shape, generator=g, device="cuda")
    w_nudged = dataclasses.replace(w, layers=dataclasses.replace(
        w.layers, attn_norm=w.layers.attn_norm * (1 + 2.0**-20 * nudge)))

    def seq(cfg_d, effort, impl, attn_impl, weights=w):
        return forward_seq(weights, cfg_d, ids,
                           *make_kv_cache(cfg_d, "cuda"), rope_offset=off,
                           mask_from=off, effort=effort, impl=impl,
                           attn_impl=attn_impl)[off:]

    def token_loop(cfg_d):
        kv = make_kv_cache(cfg_d, "cuda")
        out = []
        for pos in range(off, P):
            h = forward_layers(w, cfg_d, embed(w, ids[pos]), pos, *kv,
                               effort=1.0, impl="dense", rope_offset=off,
                               mask_from=off)
            out.append(dense_matvec(rms_norm(h, w.norm, cfg.norm_eps),
                                    w.output))
        return torch.stack(out)

    try:
        for depth in (4, 32):
            cfg_d = dataclasses.replace(cfg, n_layers=depth)
            pairs = {}
            for effort in (0.25, 0.5):
                eff = torch.tensor(effort, device="cuda")
                plain = seq(cfg_d, eff, "plain", "plain")
                pairs[f"kernel_vs_plain_{effort}"] = (
                    seq(cfg_d, eff, "kernel", "flash"), plain)
                pairs[f"plain_nudged_vs_plain_{effort}"] = (
                    seq(cfg_d, eff, "plain", "plain", w_nudged), plain)
            pairs["dense_seq_vs_token"] = (seq(cfg_d, 1.0, "dense", "flash"),
                                           token_loop(cfg_d))
            for what, (a, b) in pairs.items():
                cs = [cos(x, y) for x, y in zip(a, b)]
                r = dict(depth=depth, pair=what, positions=len(cs),
                         min_cos=min(cs), mean_cos=sum(cs) / len(cs),
                         argmax_agreement=float(
                             (a.argmax(-1) == b.argmax(-1)).float().mean()),
                         finite=bool(torch.isfinite(a).all()),
                         required=depth == 4 and "nudged" not in what)
                rows.append(r)
                emit({"phase": "prefill_teacher", **r})
                if not r["finite"] or (r["required"]
                                       and not r["min_cos"] >= 0.999):
                    raise AssertionError(f"prefill teacher check: {r}")
            if depth == 32:
                for effort in (0.25, 0.5):
                    r = dict(depth=depth, pair=f"same_input_{effort}",
                             **same_input_layers(
                                 seq, cfg_d, torch.tensor(effort,
                                                          device="cuda")))
                    r["min_cos"] = min(r["k2_min_cos"] + r["k3_min_cos"])
                    r["required"] = True
                    rows.append(r)
                    emit({"phase": "prefill_teacher", **r})
                    if not (r["min_cos"] >= 0.9999 and all(r["k2_c_equal"])):
                        raise AssertionError(f"same-input check: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


SERVE_LENS = (5, 64, 17, 40, 9, 33, 60, 24)
SERVE_EFFORTS = (0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.25, 0.5)


def phase_serve(cfg, w, eng, prompts) -> list:
    """Continuous batching: BatchEngine(batch_size=4) + ContinuousBatcher
    serve 8 requests through 4 slots (prompt lengths 5-64, efforts mixed,
    32 new tokens each), then a teacher check of one batched step against
    the single-stream K1 route, then the HTTP server in batch mode."""
    g = torch.Generator().manual_seed(11)
    reqs = [torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
            for n in SERVE_LENS]
    be = BatchEngine(w, cfg, batch_size=4, eos_id=-1)
    cb = ContinuousBatcher(be)
    cb.submit(reqs[0], 2, 0.25, lambda toks: None)        # warm-up
    cb.run_until_drained()
    done = {}
    for i, (p, e) in enumerate(zip(reqs, SERVE_EFFORTS)):
        cb.submit(p, N_NEW, e, lambda toks, i=i: done.__setitem__(i, toks))
    torch.cuda.synchronize()
    reset_launches()                    # the path's run starts here ...
    t0 = time.perf_counter()
    ticks = 0
    while cb.has_work():
        cb.tick()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)           # ... and is read here
    L, admits = cfg.n_layers, len(reqs)
    r = dict(requests=admits, slots=4, new_tokens=N_NEW, steps=ticks,
             wall_s=wall, tokens_per_s=admits * N_NEW / wall,
             ms_per_step=wall * 1e3 / ticks, launches=launches,
             first_tokens=done.get(0, [])[:8])
    emit({"phase": "serve", **r})
    check_replies([done.get(i) or [] for i in range(admits)], cfg, N_NEW,
                  "serve")
    check_launches(launches, {"mxu_matvec_batch": 4 * L * (ticks + admits),
                              "flash_attention": L * admits,
                              "mxu_matvec": 0}, "serve")
    # where serving time goes: four requests of 8 tokens filling the slots
    def wave():
        for p, e in zip(reqs[:4], SERVE_EFFORTS):
            cb.submit(p, 8, e, lambda toks: None)
        cb.run_until_drained()
    r["profile"] = device_profile(wave)
    emit({"phase": "serve_profile", "requests": 4, "new_tokens": 8,
          **r["profile"]})
    r["teacher"] = serve_teacher(cfg, w, reqs)
    r["http"] = serve_http(cfg, w)
    return [r]


def serve_teacher(cfg, w, reqs) -> list:
    """At depth 4 and tau = 1, one batched decode step's logits for each
    slot against forward_token on the single-stream K1 route at the slot's
    effort, both reading copies of the same cache (exact bf16 head)."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    w_exact = dataclasses.replace(w, output_q=None, output_qscale=None)
    try:
        be = BatchEngine(w_exact, cfg4, batch_size=4, eos_id=-1)
        for b in range(4):
            be.admit(b, b, reqs[b], N_NEW, SERVE_EFFORTS[b])
        for _ in range(3):
            be.step()
        kc, vc = be.k_cache.clone(), be.v_cache.clone()
        lb = forward_token_batch(be.w, cfg4, be.tokens, be.pos, kc, vc,
                                 be.efforts, offs=be.offs, impl="kernel")
        rows = []
        for b in range(4):
            kv = (be.k_cache[:, b].clone(), be.v_cache[:, b].clone())
            pos, off = int(be.pos[b]), int(be.offs[b])
            ls = forward_token(be.w, cfg4, be.tokens[b], pos, *kv,
                               effort=effort_q16(SERVE_EFFORTS[b], "cuda"),
                               impl="kernel", rope_offset=off, mask_from=off)
            rows.append(dict(slot=b, effort=SERVE_EFFORTS[b], pos=pos,
                             cos=cos(lb[b], ls),
                             argmax_equal=bool(lb[b].argmax()
                                               == ls.argmax())))
        emit({"phase": "serve_teacher", "slots": rows})
        if not all(x["cos"] >= 0.999 for x in rows):
            raise AssertionError(f"batched step vs single stream: {rows}")
    finally:
        fused_stream._TAU = saved
    return rows


def serve_http(cfg, w) -> dict:
    """make_batch_server on 127.0.0.1 (a free port), in this process: four
    concurrent /q requests, one stream=1 request and one /v1/completions
    request. Every answer must be 200 with its full token count (or end at
    the end-of-sequence id 2)."""
    import asyncio
    import urllib.request
    n = 8

    def fetch(port, path, payload=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=None if payload is None else json.dumps(payload).encode(),
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read().decode()

    def full(toks):
        return len(toks) == n or (0 < len(toks) < n and toks[-1] == 2)

    async def run():
        srv = make_batch_server(w, cfg, batch_size=4, port=0)
        await srv.start()
        loop = asyncio.get_running_loop()
        try:
            t0 = time.perf_counter()
            got = await asyncio.gather(*[
                loop.run_in_executor(None, fetch, srv.port,
                                     f"/q?query=hello{i}&effort={e}"
                                     f"&numtokens={n}")
                for i, e in enumerate((25, 50, 100, 25))])
            concurrent_s = time.perf_counter() - t0
            streamed = await loop.run_in_executor(
                None, fetch, srv.port,
                f"/q?query=stream&effort=50&numtokens={n}&stream=1")
            completion = await loop.run_in_executor(
                None, fetch, srv.port, "/v1/completions",
                {"prompt": "hello", "max_tokens": n, "effort": 0.5})
        finally:
            await srv.stop()
        return got, streamed, completion, concurrent_s

    got, streamed, completion, concurrent_s = asyncio.run(run())
    ok = all(st == 200 and full(json.loads(body)["token_ids"])
             for st, body in got)
    st, body = streamed
    events = [e for e in body.split("\n\n") if e.strip()]
    data = [json.loads(e.split("data: ", 1)[1]) for e in events
            if e.startswith("data: ")]
    final = [json.loads(e.split("data: ", 1)[1]) for e in events
             if e.startswith("event: done")]
    ok &= (st == 200 and len(final) == 1 and full(final[0]["token_ids"])
           and [d["token"] for d in data] == final[0]["token_ids"])
    st, body = completion
    obj = json.loads(body)
    ok &= (st == 200 and obj["object"] == "text_completion"
           and full(json.loads(obj["choices"][0]["text"])))
    r = dict(concurrent_q=[st for st, _ in got], concurrent_s=concurrent_s,
             stream_events=len(data), completion=obj["choices"][0], ok=ok)
    emit({"phase": "serve_http", **r})
    if not ok:
        raise AssertionError(f"batch server: {r}")
    return r

def rank_bytes(bm, tiles: int, tgb: int, selection: bool) -> int:
    """Bytes K4 or K5 must move: values and packed positions of the live
    tiles, y written once, and K4's v, probes, stats and scales (selection)
    or K5's u [K, in] f32."""
    vrow = bm.vals.shape[2] * bm.vals.element_size()
    streamed = tiles * tgb * bm.chunk_rows * (vrow + bm.pos.shape[2])
    K = bm.n_ranks
    if selection:
        inputs = (bm.in_dim * 4 * (1 + K * (1 + (bm.scales is not None)))
                  + bm.probes.shape[1] * 4)
    else:
        inputs = K * bm.in_dim * 4
    return streamed + inputs + bm.out_dim * 4


def gather_bytes(bm, n_ids: int, pos_row_bytes: int) -> int:
    """Bytes K6 or K7 must move for n_ids real blocks: their values and
    positions, their ids, u [K, in] f32, y written once."""
    vrow = bm.vals.shape[2] * bm.vals.element_size()
    return (n_ids * bm.chunk_rows * (vrow + pos_row_bytes) + n_ids * 4
            + bm.n_ranks * bm.in_dim * 4 + bm.out_dim * 4)


def held(what: str, y, yr, extra: dict, c_min: float = 0.9999) -> dict:
    """cos and max|dy| of a kernel against its plain version (and whether
    the two are equal bit for bit, as K4-K7 and theirs add in one order);
    raises past cos c_min or max|dy| > 1e-2 max|y_ref|."""
    err = float((y - yr).abs().max())
    scale = float(yr.abs().max())
    p = dict(extra, cos=cos(y, yr), max_abs_err=err, max_abs_ref=scale,
             bitwise_equal=bool(torch.equal(y, yr)))
    if not p["cos"] >= c_min or not err <= 1e-2 * scale:
        raise AssertionError(f"{what} disagrees with its plain version: {p}")
    return p


def timed(p: dict, flush, fn, plain, args: list, nbytes: int,
          lib_ms: float) -> dict:
    """ms (median over the fresh args, L2 flushed), plain_ms (over the
    first PLAIN_RUNS of them: the plain versions add row by row, in the
    kernels' order), the bytes bound and the library time."""
    p["ms"] = median([gpu_ms(fn, a, flush) for a in args])
    p["plain_ms"] = median([gpu_ms(plain, a, flush)
                            for a in args[:PLAIN_RUNS]])
    p["bytes"] = nbytes
    p["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    p["library_ms"] = lib_ms
    return p


def phase_kernels_rank(flush: torch.Tensor) -> dict:
    """K4 and K5 at the four fused projections x {bf16, int8, int4} x
    RANK_EFFORTS x TAUS; K6 and K7 at {bf16, int8} x RANK_EFFORTS; each
    against its plain version on the same selection, K5 against K4 and K7
    against K6."""
    g = torch.Generator(device="cuda")
    g.manual_seed(2468)
    out = {k: [] for k in ("k4", "k5", "k6", "k7")}
    for name, (i, o) in SHAPES.items():
        rms = torch.exp(torch.randn(i, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((i, o), generator=g, device="cuda") * 0.02
        dense = wt[pi.long()].to(torch.bfloat16)
        vs = [rms[pi.long()] * torch.randn(i, generator=g, device="cuda")
              for _ in range(RUNS)]
        lib_ms = median([gpu_ms(lambda a: torch.mm(a, dense),
                                (v.to(torch.bfloat16)[None],), flush)
                         for v in vs])
        del dense
        for dtype in DTYPES:
            bm = bucketize(wt, BucketConfig(dtype=dtype, **RANK_BUCKETS),
                           in_perm=pi)
            tgb = bucketmul._tile_blocks(bm)
            base = dict(shape=name, in_dim=i, out_dim=o, dtype=dtype,
                        n_chunks=bm.n_chunks, tile_blocks=tgb)
            for effort in RANK_EFFORTS:
                eq = effort_q16(effort, "cuda")
                for tau in TAUS:
                    pt = dict(base, effort=effort, tau=tau)
                    y, C, sel = fused_stream.fused_matvec(
                        bm, vs[0], eq, 0, tgb, tau, return_selection=True)
                    yr, Cr, _ = fused_stream.fused_matvec_ref(
                        bm, vs[0], eq, 0, tgb, tau, return_selection=True)
                    y5 = prefix_stream.stream_matvec(bm, sel, tgb)
                    torch.cuda.synchronize()
                    C, Cr = C.tolist(), Cr.tolist()
                    tiles = int(sel.cum_tiles[-1])
                    p4 = held("K4", y, yr, dict(pt, C=C, C_plain=Cr,
                                                 tiles=tiles))
                    p4["k5_on_k4_selection_max_abs_diff"] = float(
                        (y5 - y).abs().max())
                    if C != Cr or not p4["bitwise_equal"] or not p4[
                            "k5_on_k4_selection_max_abs_diff"] <= 1e-5:
                        raise AssertionError(f"K4 (C_k, y bit for bit, or "
                                             f"K5 on its selection): {p4}")
                    out["k4"].append(timed(
                        p4, flush,
                        lambda v: fused_stream.fused_matvec(bm, v, eq, 0,
                                                            tgb, tau),
                        lambda v: fused_stream.fused_matvec_ref(
                            bm, v, eq, 0, tgb, tau),
                        [(v,) for v in vs],
                        rank_bytes(bm, tiles, tgb, True), lib_ms))
                    if (dtype, effort, tau) == SUMMARY_RANK:
                        # where a call's device time goes (selection,
                        # stream, split sum): the mean over PROFILE_CALLS
                        # calls
                        prof = device_profile(lambda: [
                            fused_stream.fused_matvec(bm, v, eq, 0, tgb,
                                                      tau)
                            for v in vs[:PROFILE_CALLS]])["kernel_ms"]
                        p4["parts_ms"] = {k: ms / PROFILE_CALLS
                                          for k, ms in prof.items()}
                    emit({"phase": "kernels_rank", "kernel": "K4", **p4})
                    sels = [prefix_stream.select_stream(bm, v, eq, 0, tgb,
                                                        tau=tau)
                            for v in vs]
                    y5 = prefix_stream.stream_matvec(bm, sels[0], tgb)
                    y5r = prefix_stream.stream_matvec_ref(bm, sels[0], tgb)
                    tiles5 = (sels[0].cum_tiles[1:]
                              - sels[0].cum_tiles[:-1]).tolist()
                    p5 = held("K5", y5, y5r, dict(pt, tiles_per_rank=tiles5))
                    if not p5["bitwise_equal"]:
                        raise AssertionError(f"K5 not bit for bit: {p5}")
                    out["k5"].append(timed(
                        p5, flush,
                        lambda s: prefix_stream.stream_matvec(bm, s, tgb),
                        lambda s: prefix_stream.stream_matvec_ref(bm, s,
                                                                  tgb),
                        [(s,) for s in sels],
                        rank_bytes(bm, sum(tiles5), tgb, False), lib_ms))
                    emit({"phase": "kernels_rank", "kernel": "K5", **p5})
                if dtype == "int4":
                    continue
                gather_points(bm, base, effort, vs, flush, lib_ms, out)
            del bm
        del wt, vs
        torch.cuda.empty_cache()
    return out


def gather_points(bm, base, effort, vs, flush, lib_ms, out) -> None:
    """K6 and K7 at one effort: the gather route's capacity, one selection
    per fresh input, each kernel against its plain version and K7 against
    K6, all bit for bit."""
    cap = bucketmul.gather_capacity(bm, effort)
    pos7 = gather_mul.unpacked_positions(bm)
    sels = [select_blocks(bm, v, effort, 0, cap) for v in vs]
    y6 = gather_dma.gather_matvec_dma(bm, sels[0])
    y6r = gather_dma.gather_matvec_dma_ref(bm, sels[0])
    y7 = gather_mul.gather_bucket_matvec(bm, sels[0], pos7)
    y7r = gather_mul.gather_bucket_matvec_ref(bm, sels[0], pos7)
    torch.cuda.synchronize()
    n_blocks = int(sels[0].n_blocks)
    real = min(n_blocks, cap)           # the bound counts no pad block
    pt = dict(base, effort=effort, max_blocks=cap, n_blocks=n_blocks,
              blocks=bm.blocks_per_expert)
    p6 = held("K6", y6, y6r, dict(pt))
    p7 = held("K7", y7, y7r, dict(pt))
    p7["k7_vs_k6_max_abs_diff"] = float((y7 - y6).abs().max())
    if not 1 <= n_blocks <= bm.blocks_per_expert or not torch.equal(y7, y6) \
            or not p6["bitwise_equal"] or not p7["bitwise_equal"]:
        raise AssertionError(f"K6/K7 selection, y bit for bit, or K7 "
                             f"against K6: {p6} {p7}")
    out["k6"].append(timed(
        p6, flush, lambda s: gather_dma.gather_matvec_dma(bm, s),
        lambda s: gather_dma.gather_matvec_dma_ref(bm, s),
        [(s,) for s in sels], gather_bytes(bm, real, bm.pos.shape[2]),
        lib_ms))
    emit({"phase": "kernels_rank", "kernel": "K6", **p6})
    out["k7"].append(timed(
        p7, flush, lambda s: gather_mul.gather_bucket_matvec(bm, s, pos7),
        lambda s: gather_mul.gather_bucket_matvec_ref(bm, s, pos7),
        [(s,) for s in sels], gather_bytes(bm, real, pos7.shape[2]), lib_ms))
    emit({"phase": "kernels_rank", "kernel": "K7", **p7})


def build_rank_model():
    """Mistral-7B width and depth, int8 rank-prefix buckets (B = 4, G =
    16), fused wqkv and w13, int8 LM head, no dense copies (so effort 1.0
    runs K4 at full coverage); random calibrated weights from seed 0."""
    cfg = mistral_7b(n_layers=32, max_seq_len=512)
    bcfg = BucketConfig(dtype="int8", **RANK_BUCKETS)
    t0 = time.perf_counter()
    w = quantize_head(init_random_weights(cfg, bcfg, seed=0, calibrate=True,
                                          fuse=True, device="cuda"))
    torch.cuda.synchronize()
    emit({"phase": "rank_model_setup", "seconds": time.perf_counter() - t0,
          "weights_gib": torch.cuda.memory_allocated() / 2**30})
    return cfg, w


RANK_ROUTES = {"auto": "fused_matvec", "stream": "stream_matvec",
               "gather": "gather_matvec_dma"}


def only(name: str, steps: int, L: int) -> dict:
    """The launch counts of a decode path that runs kernel `name` alone: 4
    projections a layer a step, every other kernel 0."""
    return {k: (4 * L * steps if k == name else 0) for k in LAUNCHES}


def phase_rank_decode(cfg, w, prompts) -> dict:
    """Single-stream decode on the rank-prefix model: the four prompts at
    efforts 0.25, 0.5 and 1.0 through "auto" (K4), one prompt of a few
    tokens through "stream" (K5) and "gather" (K6), each with exact launch
    counts; then one request under the profiler."""
    L, out = cfg.n_layers, {"decode": [], "routes": []}
    eng = Engine(w, cfg, eos_id=-1)
    eng.generate(prompts[0], n_new=2, effort=0.25)       # warm-up
    steps = sum(padded(n, eng.pad_to) + N_NEW - 1 for n in PROMPT_LENS)
    for effort in (0.25, 0.5, 1.0):
        torch.cuda.synchronize()
        reset_launches()                # the path's run starts here ...
        t0 = time.perf_counter()
        reps = [eng.generate(p, n_new=N_NEW, effort=effort) for p in prompts]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)       # ... and is read here
        r = dict(effort=effort, requests=len(prompts), steps=steps, ms=ms,
                 ms_per_token=ms / steps, launches=launches,
                 first_tokens=reps[0].token_ids[:8])
        out["decode"].append(r)
        emit({"phase": "rank_decode", **r})
        check_replies([x.token_ids for x in reps], cfg, N_NEW,
                      f"rank decode, effort {effort}")
        check_launches(launches, only("fused_matvec", steps, L),
                       f"rank decode at effort {effort}")
    out["replies"] = reps
    n_new, pad = 4, 8
    for impl in ("stream", "gather"):
        e = Engine(w, cfg, impl=impl, eos_id=-1, pad_to=pad)
        e.generate(prompts[0], n_new=2, effort=0.25)     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rep = e.generate(prompts[0], n_new=n_new, effort=0.25)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
        st = padded(len(prompts[0]), pad) + n_new - 1
        r = dict(impl=impl, effort=0.25, steps=st, ms_per_token=ms / st,
                 launches=launches, tokens=rep.token_ids)
        out["routes"].append(r)
        emit({"phase": "rank_decode_route", **r})
        check_replies([rep.token_ids], cfg, n_new, f"rank decode, {impl}")
        check_launches(launches, only(RANK_ROUTES[impl], st, L),
                       f"rank decode through {impl}")
        if impl == "gather":
            # K6's share of the route's device time, over two tokens
            r["profile"] = device_profile(lambda: e.generate(
                prompts[0], n_new=2, effort=0.25))
            r["profile"]["steps"] = padded(len(prompts[0]), pad) + 1
            emit({"phase": "rank_gather_profile", **r["profile"]})
    out["profile"] = device_profile(lambda: eng.generate(
        prompts[0], n_new=8, effort=0.25))
    emit({"phase": "rank_profile", "steps": padded(len(prompts[0])) + 7,
          **out["profile"]})
    return out


def phase_rank_same_input(cfg, w, prompt) -> list:
    """At depth 32, every K4 call of a few decode steps run through its
    plain version too, on the very inputs it was given: per layer the
    least cosine and whether every C_k matched (required: >= 0.9999 and
    all equal)."""
    k4 = bucketmul.fused_matvec
    rows = []
    for effort in (0.25, 0.5):
        cs, eq_c = [], []

        def both(bm, v, effort, expert=0, tile_blocks=8, tau=None):
            y, C, _ = k4(bm, v, effort, expert, tile_blocks, tau,
                         return_selection=True)
            yr, Cr, _ = fused_stream.fused_matvec_ref(
                bm, v, effort, expert, tile_blocks, tau,
                return_selection=True)
            cs.append(torch.nn.functional.cosine_similarity(
                y.double(), yr.double(), dim=0))
            eq_c.append((C == Cr).all())
            return y
        bucketmul.fused_matvec = both
        try:
            kv = make_kv_cache(cfg, "cuda")
            eq = effort_q16(effort, "cuda")
            for pos, tok in enumerate(prompt):
                forward_token(w, cfg, tok, pos, *kv, effort=eq, impl="kernel")
        finally:
            bucketmul.fused_matvec = k4
        L = cfg.n_layers
        n = len(prompt)
        if len(cs) != 4 * L * n:
            raise AssertionError(f"{len(cs)} K4 calls in {n} steps of {L} "
                                 f"layers")
        per_layer = torch.stack(cs).reshape(n, L, 4).amin(dim=(0, 2))
        c_ok = torch.stack(eq_c).reshape(n, L, 4).all(dim=2).all(dim=0)
        r = dict(depth=L, effort=effort, steps=n, calls=len(cs),
                 k4_min_cos=per_layer.tolist(),
                 k4_c_equal=c_ok.tolist(),
                 min_cos=float(per_layer.min()), required=True)
        rows.append(r)
        emit({"phase": "rank_same_input", **r})
        if not (r["min_cos"] >= 0.9999 and all(r["k4_c_equal"])):
            raise AssertionError(f"rank same-input check: {r}")
    return rows


def phase_rank_teacher(cfg, w, tokens) -> list:
    """At depth 4 and tau = 1, the kernel route (K4) against the plain
    route over the same tokens, both reading the kernel route's history:
    cos >= 0.999 of the exact-head logits at every step."""
    saved = fused_stream._TAU
    fused_stream._TAU = 1.0
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    rows = []
    try:
        for effort in (0.25, 0.5):
            eq = effort_q16(effort, "cuda")
            kv = make_kv_cache(cfg4, "cuda")
            cs = []
            for pos, tok in enumerate(tokens):
                hp = forward_layers(w, cfg4, embed(w, tok), pos,
                                    *(x.clone() for x in kv), effort=eq,
                                    impl="plain")
                hk = forward_layers(w, cfg4, embed(w, tok), pos, *kv,
                                    effort=eq, impl="kernel")
                cs.append(cos(dense_matvec(rms_norm(hk, w.norm,
                                                    cfg.norm_eps), w.output),
                              dense_matvec(rms_norm(hp, w.norm,
                                                    cfg.norm_eps), w.output)))
            r = dict(depth=4, effort=effort, steps=len(tokens),
                     min_cos=min(cs), mean_cos=sum(cs) / len(cs))
            rows.append(r)
            emit({"phase": "rank_teacher", **r})
            if not r["min_cos"] >= 0.999:
                raise AssertionError(f"rank kernel route vs plain: {r}")
    finally:
        fused_stream._TAU = saved
    return rows


def rank_http(cfg, w) -> dict:
    """make_server (single flight) on the rank-prefix model at 127.0.0.1
    (a free port), in this process: three /q requests of 8 tokens at
    efforts 25, 50 and 100, each answered 200 with 8 tokens, K4 launched 4 *
    32 times a step behind the server and no other kernel."""
    import asyncio
    import urllib.request
    n, queries = 8, ("hello", "rank prefix", "effort")
    eng = Engine(w, cfg, eos_id=-1)

    def fetch(port, q, effort):
        url = (f"http://127.0.0.1:{port}/q?query={q.replace(' ', '+')}"
               f"&effort={effort}&numtokens={n}")
        with urllib.request.urlopen(url, timeout=300) as resp:
            return resp.status, json.loads(resp.read().decode())

    async def run():
        srv = make_server(eng, port=0)
        await srv.start()
        loop = asyncio.get_running_loop()
        try:
            return [await loop.run_in_executor(None, fetch, srv.port, q, e)
                    for q, e in zip(queries, (25, 50, 100))]
        finally:
            await srv.stop()

    torch.cuda.synchronize()
    reset_launches()
    got = asyncio.run(run())
    launches = dict(LAUNCHES)
    # the server's prompt: id 1, then one id a character
    steps = sum(padded(1 + len(q)) + n - 1 for q in queries)
    toks = [json.loads(body["reply"]) for _, body in got]
    r = dict(status=[st for st, _ in got], tokens=toks, launches=launches,
             ok=all(st == 200 and len(t) == n for (st, _), t in zip(got,
                                                                  toks)))
    emit({"phase": "rank_http", **r})
    if not r["ok"]:
        raise AssertionError(f"rank-prefix server: {r}")
    check_launches(launches, only("fused_matvec", steps, cfg.n_layers),
                   "the server on the rank-prefix model")
    return r


def summary_row(name: str, source: str, replaces: str, points: list,
                launches: int, pick) -> dict:
    """One kernel's entry of the `kernels` line: times summed over the
    points `pick` selects (one layer's launches, or one call), the largest
    error over all points."""
    rows = [p for p in points if pick(p)]
    by = {p["bound_by"] for p in rows if "bound_by" in p} or {"bytes"}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(p["max_abs_err"] for p in points),
            "ms": sum(p["ms"] for p in rows),
            "plain_ms": sum(p["plain_ms"] for p in rows),
            "bound_ms": sum(p["bound_ms"] for p in rows),
            "bound_by": "operations" if by == {"operations"} else "bytes",
            "library_ms": sum(p["library_ms"] for p in rows)}


def k2_row(points: list, launches: int) -> dict:
    """K2's entry: the T = 64 summary, and the T = 4 one under "_t4"
    keys."""
    row = summary_row(
        "mxu_matvec_batch", "effort_tpu_torch/csrc/mxu_matvec_batch.cu",
        "effort_tpu/kernels/fused_stream.py:391", points, launches,
        lambda p: (p["dtype"], p["T"], p["tau"]) == SUMMARY_BATCH)
    t4 = summary_row(
        "", "", "", points, 0,
        lambda p: (p["dtype"], p["T"], p["tau"]) == SUMMARY_BATCH_T4)
    row.update({f"{k}_t4": t4[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})
    for key, T in (("parts_ms", SUMMARY_BATCH[1]),
                   ("parts_ms_t4", SUMMARY_BATCH_T4[1])):
        parts = [p["parts_ms"] for p in points
                 if (p["dtype"], p["T"], p["tau"]) == (SUMMARY_BATCH[0], T,
                                                       SUMMARY_BATCH[2])]
        row[key] = {k: sum(q.get(k, 0.0) for q in parts)
                    for k in ("k2_select", "k2_stream", "k2_reduce")}
    return row


def gather_row(name: str, source: str, replaces: str, points: list,
               launches: int) -> dict:
    """K6's or K7's entry, with its ms at each projection of the summary
    (ms_by_shape: one launch each)."""
    pick = lambda p: (p["dtype"], p["effort"]) == SUMMARY_RANK[:2]  # noqa
    row = summary_row(name, source, replaces, points, launches, pick)
    row["ms_by_shape"] = {p["shape"]: p["ms"] for p in points if pick(p)}
    return row


def k4_row(points: list, launches: int) -> dict:
    """K4's entry, with where one layer's four calls spend their device
    time (parts_ms: selection, stream, split sum)."""
    pick = lambda p: (p["dtype"], p["effort"],   # noqa: E731
                      p.get("tau", 0.97)) == SUMMARY_RANK
    row = summary_row(
        "fused_matvec", "effort_tpu_torch/csrc/fused_matvec.cu",
        "effort_tpu/kernels/fused_stream.py:145", points, launches, pick)
    parts = [p["parts_ms"] for p in points if pick(p)]
    row["parts_ms"] = {k: sum(q.get(k, 0.0) for q in parts)
                       for k in ("k4_select", "k4_k5_stream",
                                 "split_sum")}
    return row


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    out = {"device": name, "nvidia_smi": smi, "phase_seconds": {}}

    def run(key, fn, *args):
        """fn(*args) into out[key], its wall seconds into phase_seconds."""
        t0 = time.perf_counter()
        out[key] = fn(*args)
        out["phase_seconds"][key] = time.perf_counter() - t0
        return out[key]

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    run("points", phase_kernels, flush)
    run("points_batch", phase_kernels_batch, flush)
    run("attention", phase_attention, flush)
    run("points_rank", phase_kernels_rank, flush)
    del flush
    torch.cuda.empty_cache()
    model = build_model()
    replies = run("generate", phase_generate, *model)[1]
    out["generate"] = out["generate"][0]
    run("profile", phase_profile, model[2], model[3][0])
    run("teacher", phase_teacher, *model[:2],
        model[3][0] + replies[0.25][0].token_ids)
    run("prefill", phase_prefill, *model)
    run("prefill_teacher", phase_prefill_teacher, *model)
    run("serve", phase_serve, *model)
    prompts = model[3]
    del model, replies
    torch.cuda.empty_cache()

    cfg, w = build_rank_model()
    rank = run("rank_decode", phase_rank_decode, cfg, w, prompts)
    reply = rank.pop("replies")[0].token_ids
    run("rank_same_input", phase_rank_same_input, cfg, w, prompts[0][:2])
    run("rank_teacher", phase_rank_teacher, cfg, w, prompts[0] + reply[:8])
    run("rank_http", rank_http, cfg, w)
    del w
    torch.cuda.empty_cache()
    emit({"phase": "phase_seconds", **out["phase_seconds"]})

    rank_launches = {k: sum(r["launches"][k]
                            for r in rank["decode"] + rank["routes"])
                     + out["rank_http"]["launches"][k]
                     for k in ("fused_matvec", "stream_matvec",
                               "gather_matvec_dma", "gather_bucket_matvec")}
    summary_rank = lambda p: (p["dtype"], p["effort"],   # noqa: E731
                              p.get("tau", 0.97)) == SUMMARY_RANK
    out["kernels"] = kernels = [
        summary_row(
            "mxu_matvec", "effort_tpu_torch/csrc/mxu_matvec.cu",
            "effort_tpu/kernels/fused_stream.py:270", out["points"],
            sum(r["launches"]["mxu_matvec"]
                for r in out["generate"] + out["prefill"]),
            lambda p: (p["dtype"], p["effort"], p["tau"]) == SUMMARY),
        k2_row(out["points_batch"],
               sum(r["launches"]["mxu_matvec_batch"]
                   for r in out["prefill"] + out["serve"])),
        summary_row(
            "flash_attention", "effort_tpu_torch/csrc/flash_attention.cu",
            "effort_tpu/kernels/flash_attention.py:36", out["attention"],
            sum(r["launches"]["flash_attention"]
                for r in out["prefill"] + out["serve"]),
            lambda p: p["case"] == SUMMARY_ATTN),
        k4_row(out["points_rank"]["k4"], rank_launches["fused_matvec"]),
        summary_row(
            "stream_matvec", "effort_tpu_torch/csrc/stream_matvec.cu",
            "effort_tpu/kernels/prefix_stream.py:91",
            out["points_rank"]["k5"], rank_launches["stream_matvec"],
            summary_rank),
        gather_row(
            "gather_matvec_dma", "effort_tpu_torch/csrc/gather_dma.cu",
            "effort_tpu/kernels/gather_dma.py:34",
            out["points_rank"]["k6"], rank_launches["gather_matvec_dma"]),
        gather_row(
            "gather_bucket_matvec", "effort_tpu_torch/csrc/gather_mul.cu",
            "effort_tpu/kernels/gather_mul.py:36",
            out["points_rank"]["k7"], rank_launches["gather_bucket_matvec"])]
    out["seconds"] = time.perf_counter() - t_start
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump(out, f, indent=1)
    emit({"phase": "done", "seconds": out["seconds"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
