"""Quality/perf evaluation harness (the JAX package's eval/harness.py, over
the port's Engine).

The reference's three benchmark families:
  - matrix_quality_sweep: cos-sim of bucketMul vs the dense product on one
    weight matrix across the effort scale.
  - agreement_sweep: generate a text at effort=1, re-feed it, and measure
    per-position argmax agreement at lower efforts.
  - run_quiz: multiple-choice QA via the limit-logits mechanism, scored
    across the effort scale.
Beside them: teacher-forced agreement, KL and NLL sweeps over a text, the
decode speed per effort (decode_speed_sweep) and the streamed-chunk
fraction of the fused kernel's prologue on real activations
(streamed_fraction).

Routes take the port's names: "reference" (the JAX package's "jnp"),
"kernel" ("pallas"), "dense".
"""

from __future__ import annotations

import json
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def effort_scale() -> List[float]:
    """Effort grid: coarse on top, fine through the interesting low range
    (the shape of the reference's makeScale)."""
    top = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4, 0.35]
    fine = [x / 100 for x in range(30, 1, -2)]
    return top + fine


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def cossim(a, b) -> float:
    a = np.asarray(_np(a), np.float64).ravel()
    b = np.asarray(_np(b), np.float64).ravel()
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / n) if n else 0.0


def matrix_quality_sweep(bm, v, efforts: Optional[Sequence[float]] = None,
                         expert: int = 0, impl: str = "reference",
                         wt_dense=None) -> Dict[float, float]:
    """cos-sim of bucketMul vs dense per effort on one matrix, on the
    container's device. wt_dense: [in, out] (tensor or numpy); default the
    container's own reconstruction."""
    from effort_tpu_torch.ops.bucketmul import bucket_matvec
    efforts = list(efforts or effort_scale())
    dev = bm.device
    if wt_dense is None:
        wt_dense = bm.reconstruct_dense(expert)
    wt = torch.as_tensor(wt_dense).to(device=dev, dtype=torch.float32)
    v = torch.as_tensor(v).to(device=dev, dtype=torch.float32)
    y_ref = v @ wt
    out = {}
    for e in efforts:
        y = bucket_matvec(bm, v, e, expert=expert, impl=impl)
        out[e] = cossim(y, y_ref)
    return out


def agreement_sweep(engine, prompt_ids: Sequence[int], n_tokens: int = 100,
                    efforts: Optional[Sequence[float]] = None
                    ) -> Dict[float, float]:
    """% of positions where low-effort argmax == full-effort argmax over a
    full-effort-generated continuation."""
    efforts = list(efforts or effort_scale())
    gen = engine.generate(list(prompt_ids), n_new=n_tokens, effort=1.0)
    text_ids = list(prompt_ids) + gen.token_ids
    _, control = engine.prompt_logits(text_ids, effort=1.0)
    out = {}
    for e in efforts:
        _, preds = engine.prompt_logits(text_ids, effort=e)
        hits = sum(int(a == b) for a, b in zip(preds, control))
        out[e] = hits / max(1, len(control))
    return out


def tf_control_preds(engine, token_ids: Sequence[int]):
    """The engine's effort=1.0 teacher-forced argmax over `token_ids`: the
    control sequence for tf_agreement_sweep. Computed from the FULL bf16
    checkpoint's engine, it lets every derived variant (quantized /
    truncated weights) be scored against the true full model, not against
    the variant's own full-effort self."""
    _, control = engine.prompt_logits(list(token_ids), effort=1.0)
    return control


def tf_agreement_sweep(engine, token_ids: Sequence[int],
                       efforts: Optional[Sequence[float]] = None,
                       control: Optional[Sequence[int]] = None
                       ) -> Dict[float, float]:
    """Teacher-forced argmax agreement vs effort=1.0 over REAL text (the
    reference's similarity protocol runs over ~500-token texts: use >= 500
    token_ids for parity). `control`: a precomputed argmax sequence to
    score against (tf_control_preds); default this engine's own
    effort=1.0 predictions."""
    efforts = list(efforts or effort_scale())
    if control is None:
        control = tf_control_preds(engine, token_ids)
    out = {}
    for e in efforts:
        _, preds = engine.prompt_logits(list(token_ids), effort=e)
        hits = sum(int(a == b) for a, b in zip(preds, control))
        out[e] = hits / max(1, len(control))
    return out


def log_softmax(logits: np.ndarray) -> np.ndarray:
    x = np.asarray(logits, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def kl_divergence_sweep(engine, prompt_ids: Sequence[int],
                        efforts: Optional[Sequence[float]] = None
                        ) -> Dict[float, float]:
    """Mean per-position KL(P_full || P_effort) in nats over a text: the
    distribution-level quality metric (argmax agreement sees the top token
    only; KL separates "picked another good token" from "distribution
    fell apart")."""
    efforts = list(efforts or effort_scale())
    ref_lp = log_softmax(engine.position_logits(prompt_ids, effort=1.0))
    ref_p = np.exp(ref_lp)
    out = {}
    for e in efforts:
        lp = log_softmax(engine.position_logits(prompt_ids, effort=e))
        out[e] = float((ref_p * (ref_lp - lp)).sum(axis=-1).mean())
    return out


def nll_sweep(engine, token_ids: Sequence[int],
              efforts: Optional[Sequence[float]] = None
              ) -> Dict[float, float]:
    """Mean teacher-forced negative log-likelihood (nats/token) of a text
    per effort (Engine.score); exp() of a value is the perplexity."""
    efforts = list(efforts or effort_scale())
    return {e: float(-np.mean(engine.score(token_ids, effort=e)))
            for e in efforts}


def run_quiz(engine, quiz: List[dict], tokenizer,
             efforts: Optional[Sequence[float]] = None,
             shuffle_seed: int = 0, progress=None) -> Dict[float, float]:
    """Multiple-choice accuracy per effort.

    quiz items: {"question": str, "answers": [str, ...], "correct": int}.
    Answers are shuffled per item and asked as numbered options; the
    model's pick is the best next token among "1"..."N" via limit-logits.
    """
    efforts = list(efforts or effort_scale())
    rng = random.Random(shuffle_seed)
    scores = {e: 0 for e in efforts}
    for qi, item in enumerate(quiz):
        order = list(range(len(item["answers"])))
        rng.shuffle(order)
        correct_slot = order.index(item["correct"])
        opts = "\n".join(f"{i+1}. {item['answers'][j]}"
                         for i, j in enumerate(order))
        prompt = (f"[INST]{item['question']}\n{opts}\n"
                  f"Answer with a single number.[/INST] ")
        ids = tokenizer.encode(prompt)
        allowed = [tokenizer.encode(str(i + 1), bos=False)[-1]
                   for i in range(len(order))]
        for e in efforts:
            pick = engine.answer_limited(ids, allowed, effort=e)
            if pick == correct_slot:
                scores[e] += 1
        if progress:
            progress(qi + 1, len(quiz))
    return {e: s / len(quiz) for e, s in scores.items()}


def load_quiz(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def limited_quiz_sweep(engine, items: List[dict],
                       efforts: Optional[Sequence[float]] = None,
                       progress=None) -> Dict[float, float]:
    """Multiple-choice accuracy per effort via raw limit-logits, for plain
    LMs: items {"prompt_ids": [int], "allowed_ids": [int], "correct": int}
    (correct = index into allowed_ids; shuffle at build time)."""
    efforts = list(efforts or effort_scale())
    scores = {e: 0 for e in efforts}
    for qi, item in enumerate(items):
        for e in efforts:
            pick = engine.answer_limited(item["prompt_ids"],
                                         item["allowed_ids"], effort=e)
            scores[e] += int(pick == item["correct"])
        if progress:
            progress(qi + 1, len(items))
    return {e: s / max(1, len(items)) for e, s in scores.items()}


# --------------------------------------------------------------------------
# speed + streamed-fraction probes: every quality sweep can carry its own
# decode timing on the same checkpoint
# --------------------------------------------------------------------------

_GREEDY = dict(sampled=False, top_k=0, penalized=False, logprobs_k=0)


# decode_speed_sweep's clock, and the times it takes both lengths again
# while the longer one is not the slower (a slope that is not positive)
_clock = time.perf_counter
_SLOPE_TRIES = 5


def decode_speed_sweep(w, cfg, efforts: Sequence[float] = (1.0, 0.5,
                                                          0.35, 0.25),
                       include_dense: bool = True, impl: str = "kernel",
                       n_lo: int = 8, n_hi: int = 40, device=None) -> Dict:
    """Per-token greedy-decode time per effort, by two-length slope
    ((t[n_hi] - t[n_lo]) / (n_hi - n_lo): launch, capture and read-back
    overheads cancel; min of 3 per length). Each length is one generation
    of n greedy steps from a fresh token at position 0 (Engine's decode
    loop: on the card replays of the captured step, the device
    synchronized before each clock read). A host under load can make the
    shorter run the slower: both lengths are then timed again, up to
    _SLOPE_TRIES times, and a RuntimeError says so if the slope never
    comes out positive. Returns {"dense_toks_per_s", "toks_per_s_<e>",
    "speedup_vs_dense_<e>"}. include_dense needs dense copies
    (impl="dense"; attach_dense or stored copies)."""
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.models.transformer import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    toks_src = iter(range(2, 2 + 16 * (len(efforts) + 3) * 8
                          * _SLOPE_TRIES))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def per_token(impl_):
        eng = Engine(w, cfg, impl=impl_, eos_id=-1, pad_to=1,
                     device=device)

        def t_of(effort):
            def t(n):
                tok = next(toks_src) % cfg.vocab_size
                sync()
                t0 = _clock()
                eng._launch([tok], n, effort, _GREEDY, {})
                sync()
                return _clock() - t0
            t(n_lo)                       # warm: captures a cold key
            t(n_hi)
            for _ in range(_SLOPE_TRIES):
                lo = min(t(n_lo) for _ in range(3))
                hi = min(t(n_hi) for _ in range(3))
                if hi > lo:
                    return (hi - lo) / (n_hi - n_lo)
            raise RuntimeError(
                f"decode_speed_sweep: {n_hi} steps never took longer than "
                f"{n_lo} in {_SLOPE_TRIES} tries (effort {effort}, "
                f"{impl_})")
        return t_of

    out = {}
    t_dense = None
    if include_dense:
        t_dense = per_token("dense")(1.0)
        out["dense_toks_per_s"] = round(1.0 / t_dense, 1)
    pt = per_token(impl)
    for e in efforts:
        te = pt(e)
        tag = int(e * 100)
        out[f"toks_per_s_{tag}"] = round(1.0 / te, 1)
        if t_dense is not None:
            out[f"speedup_vs_dense_{tag}"] = round(t_dense / te, 3)
    return out


def chunk_prefix(bm, v: np.ndarray, e: float, inst: int, tau: float):
    """The fused kernel's prologue on the host for one row-prefix matrix:
    (streamed chunk prefix C, selected-row fraction). v: the input [in]
    (f32); the cutoff is ops.effort.compute_cutoff at the python-float
    effort, selection stat[:, 0] * |v| > cutoff, the selected masses summed
    a chunk, and C the shortest chunk prefix holding tau of them."""
    from effort_tpu_torch.ops.effort import compute_cutoff
    from effort_tpu_torch.ops.layouts import strided_sample
    nc, G = bm.n_chunks, bm.chunk_rows
    vt = torch.as_tensor(np.asarray(v, np.float32))
    vp = bm.permute_v(vt.to(bm.device), inst).float().cpu()
    probes = bm.probes[inst].float().cpu()
    cutoff = float(compute_cutoff(
        strided_sample(vp, bm.in_dim, probes.shape[0]), probes, e))
    stat = bm.stats[inst][:, 0].float().cpu().numpy()
    score = stat * np.abs(vp.numpy())
    sel = score > cutoff
    mass = np.where(sel, score, 0.0).reshape(nc, G).sum(1)
    cum = np.cumsum(mass)
    C = min(int(np.searchsorted(cum, tau * cum[-1]) + 1), nc)
    return C, float(sel.mean())


def collect_residuals(w, cfg, token_ids: Sequence[int],
                      device=None) -> np.ndarray:
    """H [T, L, dim] f32: the residual after every layer at every position
    of token_ids, effort 1.0 on the "reference" route (forward_token with
    collect_h, eager)."""
    from effort_tpu_torch.models.transformer import (forward_token,
                                                     make_kv_cache,
                                                     resolve_device)
    device = resolve_device(device)
    w = w.to(device)
    kc, vc = make_kv_cache(cfg, device)
    H = []
    for pos, tok in enumerate(token_ids):
        _, hl = forward_token(w, cfg, int(tok), pos, kc, vc, effort=1.0,
                              impl="reference", collect_h=True)
        H.append(hl.float().cpu().numpy())
    return np.stack(H)


def probe_layers(n_layers: int) -> List[int]:
    """The layers streamed_fraction probes: 1, the middle one, the last."""
    return sorted({li for li in (1, n_layers // 2, n_layers - 1)
                   if li >= 1})


def streamed_fraction(w, cfg, token_ids: Sequence[int],
                      efforts: Sequence[float] = (0.5, 0.35, 0.25),
                      tau: Optional[float] = None,
                      n_probe_tokens: int = 8, device=None) -> Dict:
    """Measured streamed-chunk fraction of the FFN up-projection on REAL
    activations: runs the model over token_ids (collect_residuals), then
    replicates the fused kernel's prologue on the host (chunk_prefix:
    cutoff -> selection -> tau-bounded chunk prefix) on the residual
    stream feeding each probed layer's FFN (the attention delta within the
    probed layer is neglected: a diagnostic estimate). speedup ~ 1 /
    streamed fraction for the streaming-bound matrices.

    Returns {"tau", "streamed_chunk_frac_<e>", "selected_row_frac_<e>"},
    and "w2_..." for the down-projection when the model has unfused w1/w3
    (its input is built from them)."""
    from effort_tpu_torch.kernels.fused_stream import _TAU
    from effort_tpu_torch.models.transformer import resolve_device, rms_norm
    from effort_tpu_torch.ops.bucketmul import bucket_matvec

    device = resolve_device(device)
    w = w.to(device)
    tau = _TAU if tau is None else tau
    H = collect_residuals(w, cfg, token_ids, device)

    layers = probe_layers(cfg.n_layers)
    tok_ids = range(max(0, len(H) - n_probe_tokens), len(H))
    # probe the up-projection (residual-stream profile) AND the
    # down-projection (FFN-hidden profile): concentration can live in
    # either space
    bm1 = w.layers.any_w1
    bm2 = (w.layers.w2 if w.layers.w1 is not None
           and w.layers.w3 is not None else None)
    out = {"tau": tau}
    for e in efforts:
        fr1, se1, fr2, se2 = [], [], [], []
        for li in layers:
            for t in tok_ids:
                hn = rms_norm(torch.from_numpy(H[t][li - 1]).to(device),
                              w.layers.ffn_norm[li], cfg.norm_eps)
                f, s = chunk_prefix(bm1, hn.cpu().numpy(), e, li, tau)
                fr1.append(f / bm1.n_chunks)
                se1.append(s)
                if bm2 is not None:
                    x1 = bucket_matvec(w.layers.w1, hn, 1.0, expert=li,
                                       impl="reference")
                    x3 = bucket_matvec(w.layers.w3, hn, 1.0, expert=li,
                                       impl="reference")
                    h2 = (torch.nn.functional.silu(x1) * x3).cpu().numpy()
                    f, s = chunk_prefix(bm2, h2, e, li, tau)
                    fr2.append(f / bm2.n_chunks)
                    se2.append(s)
        tag = int(e * 100)
        out[f"streamed_chunk_frac_{tag}"] = round(float(np.mean(fr1)), 4)
        out[f"selected_row_frac_{tag}"] = round(float(np.mean(se1)), 4)
        if fr2:
            out[f"w2_streamed_chunk_frac_{tag}"] = round(
                float(np.mean(fr2)), 4)
            out[f"w2_selected_row_frac_{tag}"] = round(
                float(np.mean(se2)), 4)
    return out
