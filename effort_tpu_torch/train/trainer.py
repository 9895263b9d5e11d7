"""Trainer for Mistral-family models (the port of the JAX package's
effort_tpu/train/trainer.py).

The inference stack serves published checkpoints; a trained model is what
lets quality at an effort be measured on weights with real margins. This
module trains a small Mistral-architecture LM (rms_norm / RoPE / GQA /
SwiGLU semantics of models/transformer.py, held against the served
function by tests/test_torch_train.py), exports HF-layout safetensors, and
convert -> load -> eval take it from there.

Design, as the JAX package's: parameters are a plain dict of f32 tensors
(HF [out, in] linears stacked over layers), not an nn.Module, so export_hf
and the weight bridge map one-to-one onto JAX's pytree. The corpus lives
on the device and batches are cut there from a seeded torch.Generator;
steps run in chunks of `scan_chunk` with no host read inside a chunk
(the schedule, the clip's test and the step count are device tensors),
and one read of the last loss plus one holdout eval after each chunk.
Each layer is recomputed in backward (torch.utils.checkpoint), as
jax.checkpoint inside the JAX trainer's scan. The optimizer is optax's
chain, copied in train/optim.py.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.transformer import resolve_device
from effort_tpu_torch.train.optim import (AdamWState, adamw_init,
                                          adamw_update, clip_by_global_norm,
                                          warmup_cosine_decay)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.02,
                device=None) -> Dict:
    """HF-layout parameters: linear weights are [out_features,
    in_features] stacked over layers, so export_hf writes them verbatim
    and convert_checkpoint's transpose convention applies unchanged. The
    keys, shapes and dtype are the JAX package's; the values are draws of
    a torch.Generator seeded with `seed` on `device` (JAX's cannot be
    reproduced: tests carry JAX's parameters across instead)."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D, H, V, L = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.n_layers
    E = cfg.n_experts
    q_out = cfg.n_heads * cfg.head_dim
    kv_out = cfg.n_kv_heads * cfg.head_dim

    def w(*shape):
        return torch.randn(shape, generator=g, device=device) * scale

    def ones(*shape):
        return torch.ones(shape, device=device)

    ffn_shape = (L, H, D) if E == 1 else (L, E, H, D)
    ffn_shape_dn = (L, D, H) if E == 1 else (L, E, D, H)
    params = {
        "embed": w(V, D),
        "norm": ones(D),
        "lm_head": w(V, D),
        "layers": {
            "attn_norm": ones(L, D),
            "ffn_norm": ones(L, D),
            "wq": w(L, q_out, D),
            "wk": w(L, kv_out, D),
            "wv": w(L, kv_out, D),
            "wo": w(L, D, q_out),
            "w1": w(*ffn_shape),
            "w2": w(*ffn_shape_dn),
            "w3": w(*ffn_shape),
        },
    }
    if E > 1:
        params["layers"]["gate"] = w(L, D, E)
    return params


def leaves(params: Dict) -> List[torch.Tensor]:
    """The parameter tensors in the JAX pytree's order (sorted keys)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out += leaves(v) if isinstance(v, dict) else [v]
    return out


# --------------------------------------------------------------------------
# forward (training: [B, T] batched, causal); semantics of
# models/transformer.py (tests/test_torch_train.py holds the logits)
# --------------------------------------------------------------------------

def _rms_norm(x, weight, eps):
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return x * inv * weight


def _rope(x, pos, head_dim, theta):
    """x [..., T, Hn, D]; pos [T]. Rotate-half, matching
    transformer.rope_rotate (HF weight convention)."""
    h = head_dim // 2
    freqs = theta ** (-torch.arange(0, h, dtype=x.dtype,
                                    device=x.device) / h)
    angle = pos.to(x.dtype)[:, None] * freqs[None, :]         # [T, h]
    cos = torch.cos(angle)[:, None, :]                         # [T, 1, h]
    sin = torch.sin(angle)[:, None, :]
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(h, l: int, lp: Dict, cfg: ModelConfig, pos, mask):
    """One decoder layer on h [B, T, dim]: (h, load-balance aux)."""
    B, T, _ = h.shape
    D, KV, rep = cfg.head_dim, cfg.n_kv_heads, cfg.kv_repeats
    hn = _rms_norm(h, lp["attn_norm"][l], cfg.norm_eps)
    q = hn @ lp["wq"][l].T
    k = hn @ lp["wk"][l].T
    v = hn @ lp["wv"][l].T
    q = _rope(q.reshape(B, T, KV * rep, D), pos, D, cfg.rope_theta)
    k = _rope(k.reshape(B, T, KV, D), pos, D, cfg.rope_theta)
    v = v.reshape(B, T, KV, D)
    # GQA as the JAX trainer's [B, T, KV, rep, D] einsum: query head
    # kv * rep + r reads KV head kv; here the rep query rows of a KV head
    # are stacked, [B, KV, rep * T, D] against [B, KV, S, D]
    qh = q.reshape(B, T, KV, rep, D).permute(0, 2, 3, 1, 4)
    qh = qh.reshape(B, KV, rep * T, D)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(float(D))
    scores = scores.view(B, KV, rep, T, T).masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1).view(B, KV, rep * T, T)
    attn = (probs @ vh).view(B, KV, rep, T, D).permute(0, 3, 1, 2, 4)
    h = h + attn.reshape(B, T, KV * rep * D) @ lp["wo"][l].T
    fn = _rms_norm(h, lp["ffn_norm"][l], cfg.norm_eps)
    if cfg.n_experts == 1:
        x1 = fn @ lp["w1"][l].T
        x3 = fn @ lp["w3"][l].T
        return h + (F.silu(x1) * x3) @ lp["w2"][l].T, h.new_zeros(())
    # MoE: top-k gating, ALL experts computed densely (training only:
    # serving runs the routed top-k). Differentiable through the kept gate
    # logits and the mean router probability; the routing one-hot carries
    # no gradient. Switch-style load-balance aux term per layer.
    E, kk = cfg.n_experts, cfg.n_experts_per_tok
    gl = fn @ lp["gate"][l]                                   # [B,T,E]
    top_vals, top_idx = torch.topk(gl, kk, dim=-1)
    gates = torch.softmax(top_vals, dim=-1)                   # [B,T,k]
    one_hot = (top_idx[..., None] == torch.arange(
        E, device=h.device)).to(gl.dtype)                     # [B,T,k,E]
    w_e = (one_hot * gates[..., None]).sum(2)                 # [B,T,E]
    x1 = torch.einsum("btd,ehd->bteh", fn, lp["w1"][l])
    x3 = torch.einsum("btd,ehd->bteh", fn, lp["w3"][l])
    y = torch.einsum("bteh,edh->bted", F.silu(x1) * x3, lp["w2"][l])
    h = h + (y * w_e[..., None]).sum(2)
    # aux: E * sum_e f_e * p_e (f = routed fraction, p = mean prob)
    f_e = one_hot.sum(2).mean((0, 1)) / kk
    p_e = torch.softmax(gl, dim=-1).mean((0, 1))
    return h, E * (f_e * p_e).sum()


def forward(params: Dict, cfg: ModelConfig, toks: torch.Tensor):
    """toks [B, T] int -> (logits [B, T, vocab] f32 (causal), the
    layers' mean load-balance aux term (0 for a dense model)).

    With gradients enabled each layer is recomputed in backward
    (checkpoint, use_reentrant=False: the aux term is an output of the
    checkpointed function): with [B, H, T, T] score tensors, keeping every
    layer's activations costs far more memory than one layer's recompute."""
    B, T = toks.shape
    pos = torch.arange(T, device=toks.device)
    h = params["embed"].index_select(0, toks.reshape(-1)).view(B, T, -1)
    mask = pos[None, :] <= pos[:, None]                       # [T, T]
    if cfg.sliding_window:
        mask &= pos[None, :] > pos[:, None] - cfg.sliding_window
    lp = params["layers"]
    auxes = []
    for l in range(cfg.n_layers):
        if torch.is_grad_enabled():
            h, aux = checkpoint(_layer, h, l, lp, cfg, pos, mask,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = _layer(h, l, lp, cfg, pos, mask)
        auxes.append(aux)
    h = _rms_norm(h, params["norm"], cfg.norm_eps)
    return h @ params["lm_head"].T, torch.stack(auxes).mean()


def next_token_loss(params: Dict, cfg: ModelConfig, toks: torch.Tensor,
                    aux_coef: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy over [B, T] batches (nats), plus
    aux_coef * load-balance term for MoE configs."""
    logits, aux = forward(params, cfg, toks[:, :-1])
    targets = toks[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    loss = (logz - gold).mean()
    if cfg.n_experts > 1:
        loss = loss + aux_coef * aux
    return loss


# --------------------------------------------------------------------------
# training loop
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TrainConfig:
    batch: int = 32
    seq_len: int = 512
    steps: int = 2000
    lr: float = 3e-4
    warmup: int = 100
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    scan_chunk: int = 25      # steps per host round-trip
    seed: int = 0
    holdout_frac: float = 0.02
    # Adam first-moment dtype: f32 params + AdamW + grads cost 16 bytes a
    # parameter; "bfloat16" stores mu in 2 bytes (the update still reads
    # it in f32, as optax's mu_dtype)
    mu_dtype: str = "float32"
    # Fixed sink token written at position 0 of every training crop (None
    # = raw crops). Random mid-document crops never show the model a
    # sequence start, so without it the attention-sink mechanism, and the
    # concentrated activations it brings, cannot form.
    bos_id: Optional[int] = None


def _sample_batch(corpus: torch.Tensor, gen: torch.Generator, batch: int,
                  seq_len: int, lo: int, hi: int,
                  bos_id: Optional[int] = None) -> torch.Tensor:
    """Random [batch, seq_len] int32 crops of corpus[lo:hi], cut on the
    corpus's device: starts in [lo, hi - seq_len - 1), at least lo + 1 as
    the upper end (jax.random.randint's clamp)."""
    starts = torch.randint(lo, max(lo + 1, hi - seq_len - 1), (batch,),
                           generator=gen, device=corpus.device)
    idx = starts[:, None] + torch.arange(seq_len, device=corpus.device)
    toks = corpus.index_select(0, idx.reshape(-1)).view(batch, seq_len)
    if bos_id is not None:
        toks[:, 0] = bos_id
    return toks.to(torch.int32)


def run_chunk(params: Dict, state: AdamWState, cfg: ModelConfig,
              tcfg: TrainConfig, corpus: torch.Tensor, split: int,
              gen: torch.Generator) -> torch.Tensor:
    """tcfg.scan_chunk training steps on batches cut from corpus[:split],
    updating params and state in place; returns the steps' losses [n] on
    the device. Reads nothing back to the host."""
    ps = leaves(params)
    losses = []
    for p in ps:
        p.requires_grad_(True)
    try:
        for _ in range(tcfg.scan_chunk):
            toks = _sample_batch(corpus, gen, tcfg.batch, tcfg.seq_len, 0,
                                 split, tcfg.bos_id)
            with torch.enable_grad():
                loss = next_token_loss(params, cfg, toks)
                grads = list(torch.autograd.grad(loss, ps))
            with torch.no_grad():
                clip_by_global_norm(grads, tcfg.clip_norm)
                lr = warmup_cosine_decay(state.count, tcfg.lr, tcfg.warmup,
                                         tcfg.steps, tcfg.lr * 0.1)
                adamw_update(ps, grads, state, lr, tcfg.weight_decay)
            losses.append(loss.detach())
            del grads, loss
    finally:
        for p in ps:
            p.requires_grad_(False)
    return torch.stack(losses)


def train(cfg: ModelConfig, corpus, tcfg: Optional[TrainConfig] = None,
          params: Optional[Dict] = None, progress=print,
          deadline: Optional[float] = None, device=None):
    """Train a byte/token LM on `corpus` (1-D int array or tensor of token
    ids) on `device` (the card unless named).

    Returns (params, history) where history is a list of (step, train
    loss, holdout loss). The tail holdout_frac of the corpus is held out
    for eval and never sampled for training. Given `params`, they are
    trained in place (JAX donates them).

    Steps run in whole chunks of scan_chunk, so the count can pass `steps`
    (60 steps in chunks of 25 run 75); the schedule holds its end value
    there. `deadline`: absolute time.time() after which no further chunk
    starts; history[-1][0] is the count that ran."""
    tcfg = tcfg or TrainConfig()
    # honor step counts below one chunk (and make history[-1][0] mean what
    # it says); warmup cannot exceed the run
    tcfg = dataclasses.replace(
        tcfg, scan_chunk=max(1, min(tcfg.scan_chunk, tcfg.steps)),
        warmup=min(tcfg.warmup, max(0, tcfg.steps - 1)))
    device = resolve_device(device)
    corpus_d = (corpus if isinstance(corpus, torch.Tensor) else
                torch.from_numpy(np.asarray(corpus, np.int32))).to(
                    device, torch.int32)
    n = int(corpus_d.shape[0])
    split = int(n * (1.0 - tcfg.holdout_frac))
    params = params if params is not None else init_params(
        cfg, seed=tcfg.seed, device=device)
    state = adamw_init(leaves(params), tcfg.mu_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed + 1)

    history = []
    step = 0
    while step < tcfg.steps and (step == 0 or deadline is None
                                 or time.time() < deadline):
        losses = run_chunk(params, state, cfg, tcfg, corpus_d, split, gen)
        step += tcfg.scan_chunk
        tl = float(losses[-1])
        with torch.no_grad():
            hl = float(next_token_loss(params, cfg, _sample_batch(
                corpus_d, gen, tcfg.batch, tcfg.seq_len, split, n,
                tcfg.bos_id)))
        history.append((step, tl, hl))
        progress(f"step {step:5d}  train {tl:.4f}  holdout {hl:.4f}")
    return params, history


# --------------------------------------------------------------------------
# export: HF-layout safetensors that convert_checkpoint consumes
# --------------------------------------------------------------------------

def export_hf(params: Dict, cfg: ModelConfig, dst_dir: str) -> str:
    """Write the trained params as an HF-style safetensors checkpoint
    (the tensor names convert.HF_NAME_MAPS['mistral'] reads) plus an HF
    config.json, byte for byte the JAX package's export of the same
    params."""
    from effort_tpu_torch.convert.convert import HF_NAME_MAPS
    from effort_tpu_torch.runtime.safetensors_io import SafeTensorWriter
    os.makedirs(dst_dir, exist_ok=True)
    names = HF_NAME_MAPS["mistral"]
    wtr = SafeTensorWriter(dst_dir, "model")

    def put(name, t):
        wtr.add(name, t.detach().to("cpu", torch.float32).numpy())

    put(names["embed"], params["embed"])
    put(names["norm"], params["norm"])
    put(names["lm_head"], params["lm_head"])
    lp = params["layers"]
    for l in range(cfg.n_layers):
        put(names["attn_norm"].format(l=l), lp["attn_norm"][l])
        put(names["ffn_norm"].format(l=l), lp["ffn_norm"][l])
        for p in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            put(names[p].format(l=l), lp[p][l])
    wtr.save()
    with open(os.path.join(dst_dir, "config.json"), "w") as f:
        json.dump({
            "model_type": "mistral",
            "hidden_size": cfg.dim,
            "intermediate_size": cfg.hidden_dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim,
            "vocab_size": cfg.vocab_size,
            "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta,
            "max_position_embeddings": cfg.max_seq_len,
        }, f, indent=2)
    return dst_dir


def params_to_raw(params: Dict, cfg: ModelConfig) -> Dict:
    """Trainer params (HF [L, out, in] linears; MoE FFNs [L, E, out, in])
    -> the raw dict assemble_weights takes ([n_inst, in, out] + heads and
    norms; FFN instances packed [L * E, ...], layer-major), the port's copy
    of scripts/trained_quality_ondevice.params_to_raw."""
    lp = params["layers"]

    def t(x):
        return x.transpose(1, 2)

    def ffn(x):
        return t(x if x.dim() == 3 else x.flatten(0, 1))

    return dict(
        wq=t(lp["wq"]), wk=t(lp["wk"]), wv=t(lp["wv"]), wo=t(lp["wo"]),
        w1=ffn(lp["w1"]), w2=ffn(lp["w2"]), w3=ffn(lp["w3"]),
        ffn_gate=lp.get("gate"),
        tok_embeddings=params["embed"],
        output=params["lm_head"].T,
        attn_norm=lp["attn_norm"], ffn_norm=lp["ffn_norm"],
        norm=params["norm"],
    )


def byte_corpus_from_files(paths, limit_bytes: int = 0) -> np.ndarray:
    """Concatenate files into a uint8 byte corpus (byte-level LM ids)."""
    chunks = []
    total = 0
    for p in paths:
        try:
            with open(p, "rb") as f:
                b = f.read()
        except OSError:
            continue
        chunks.append(np.frombuffer(b, np.uint8))
        total += len(b)
        if limit_bytes and total >= limit_bytes:
            break
    corpus = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return corpus[:limit_bytes] if limit_bytes else corpus
