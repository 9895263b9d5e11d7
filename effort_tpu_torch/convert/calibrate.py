"""Activation calibration: measure per-dim activation magnitudes on a
loaded model, for the baked relayout pass (convert_checkpoint(calib=...)).

LLM residual streams have persistent outlier dims, and ordering weight
rows by them is what lets prefix streaming read only what the selection
needs. collect_act_rms runs the model on sample token sequences and returns

  rms_m [dim]    mean |rms_norm(h) * norm_w| over both per-layer norms:
                 the input magnitude profile of wq/wk/wv/w1/w3,
  rms_f [hidden] mean |silu(w1 x) * (w3 x)|: the input profile of w2,

averaged over tokens and layers (one global permutation per space: the
per-layer profiles of real LLMs are strongly correlated, because outlier
dims persist across layers).
"""

from __future__ import annotations

import torch

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.transformer import (ModelWeights, embed,
                                                 forward_token,
                                                 make_kv_cache, rms_norm)
from effort_tpu_torch.ops.bucketmul import bucket_matvec


def collect_act_rms(w: ModelWeights, cfg: ModelConfig, token_seqs,
                    impl: str = "auto") -> dict:
    """token_seqs: list of int token-id lists. Returns {"rms_m", "rms_f"},
    f32 tensors on the model's device.

    Works on an UNBAKED checkpoint (any bucket config; run at effort 1.0)
    with unfused w1/w3, as the JAX package's. Each sequence runs token by
    token through forward_token (collect_h) on the model's device: on the
    card, the card's kernels."""
    L, E = cfg.n_layers, cfg.n_experts
    lw = w.layers
    dev = w.device
    acc_m = torch.zeros(cfg.dim, device=dev)
    acc_f = torch.zeros(cfg.hidden_dim, device=dev)
    n_m = n_f = 0

    for seq in token_seqs:
        kc, vc = make_kv_cache(cfg, dev)
        for pos, tok in enumerate(seq):
            tok = int(tok)
            _, h_layers = forward_token(w, cfg, tok, pos, kc, vc,
                                        effort=1.0, impl=impl,
                                        collect_h=True)
            # h_layers[l] is the residual AFTER layer l: layer l's input is
            # h_layers[l - 1] (l >= 1) or the token's embedding (l = 0);
            # the ffn-norm profile reads the post-layer residual, a close
            # proxy for the post-attention point
            inputs = torch.cat([embed(w, tok)[None], h_layers[:-1]])
            for l in range(L):
                hn_a = rms_norm(inputs[l], lw.attn_norm[l], cfg.norm_eps)
                hn_f = rms_norm(h_layers[l], lw.ffn_norm[l], cfg.norm_eps)
                acc_m += hn_a.abs() + hn_f.abs()
                # FFN hidden profile through expert 0 (MoE experts share
                # the hidden space's statistics closely enough for one
                # global permutation)
                x1 = bucket_matvec(lw.w1, hn_f, 1.0, l * E, impl)
                x3 = bucket_matvec(lw.w3, hn_f, 1.0, l * E, impl)
                acc_f += (torch.nn.functional.silu(x1) * x3).abs()
        n_m += 2 * L * len(seq)
        n_f += L * len(seq)
    return {"rms_m": acc_m / max(n_m, 1), "rms_f": acc_f / max(n_f, 1)}
