"""The plain forward pass of DeepSeek-V2 (DeepSeek-V2, arXiv:2405.04434
2.1-2.2; modeling_deepseek.py of deepseek-ai/DeepSeek-V2-Lite), in f32, over
whole token sequences (teacher-forced), a layer at a time: reference/model.py's
contract for a DeepSeek-V2 configuration.

It follows the published architecture: RMS norms; multi-head latent attention
in its decompressed form (q = wq x; [c | k_pe] = wkv_a x; c through
kv_a_layernorm, eps 1e-6; every head's key [W_UK c | k_pe] and value W_UV c
from wkv_b; YaRN rotary embeddings; softmax scale q_head_dim ** -0.5 times
yarn_get_mscale(factor, mscale_all_dim) ** 2); a dense SiLU FFN in the first
first_k_dense_replace layers, then the gate (a softmax over all routed
experts, the top k by a stable sort, renormalised only when norm_topk_prob;
routed_scaling_factor 1), the routed experts' gated sum and the shared
experts. With the precisions that the configuration states: embeddings,
head, router and wkv_b in bf16; wq|wkv_a, wo and every FFN matrix as the
frozen effort arithmetic of reference.effort on int8 codes (the activations
they take rounded to bf16, as the selection states); the latent rows
rounded to bf16 as the cache holds them; wkv_b's two products on bf16
inputs where the configuration's absorbed form takes them (the query's
nope part, and each head's softmax-weighted sum of latents before W_UV:
the value W_UV c summed after the product); every sum and everything else
in f32 with TF32 off.

The layout the configuration states is the program's: the calibration
relayout (rows of the residual and hidden spaces in descending rms order)
and the rotary columns of wq and wkv_a de-interleaved, which turns
apply_rotary_pos_emb's de-interleave and rotate-half into rotate-half alone
(the same rotation); both decide which weights the effort arithmetic's
probes sample, so the reference quantizes the matrices in that layout.

Each layer's matrices are rebuilt from the raw blocks (`src`, the
benchmark's RawDeepseekV2) when the layer is reached and dropped after it.
It imports nothing of the program and nothing of the harness.
"""

from __future__ import annotations

import math

import torch

from reference import effort as fx

KV_NORM_EPS = 1e-6     # DeepseekV2RMSNorm's default, kv_a_layernorm's


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative error of each row of a against b ([n, ...] -> [n])."""
    d = (a - b).flatten(1).norm(dim=1)
    return d / b.flatten(1).norm(dim=1).clamp(min=1e-30)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(d, device) -> tuple:
    """(inverse frequencies [rope / 2], cos/sin multiplier) of
    DeepseekV2YarnRotaryEmbedding, or of plain RoPE without rope_scaling."""
    dim, base, sc = d.qk_rope, d.rope_theta, d.rope_scaling
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** exps)
    if not sc:
        return extra.to(device), 1.0
    inter = 1.0 / (sc["factor"] * base ** exps)
    orig = sc["original_max_position_embeddings"]

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) \
            / (2 * math.log(base))
    low = max(math.floor(corr(sc["beta_fast"])), 0)
    high = min(math.ceil(corr(sc["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    m = (yarn_mscale(sc["factor"], sc.get("mscale", 1))
         / yarn_mscale(sc["factor"], sc.get("mscale_all_dim", 0)))
    return (inter * (1 - mask) + extra * mask).to(device), m


def softmax_scale(d) -> float:
    s = (d.qk_nope + d.qk_rope) ** -0.5
    sc = d.rope_scaling
    if sc and sc.get("mscale_all_dim"):
        m = yarn_mscale(sc["factor"], sc["mscale_all_dim"])
        s = s * m * m
    return s


def rot_order(d) -> torch.Tensor:
    """The de-interleave of a rotary part: 0, 2, ..., rope - 2, 1, 3, ..."""
    P = d.qk_rope
    return torch.cat([torch.arange(0, P, 2), torch.arange(1, P, 2)])


def qa_order(d) -> torch.Tensor:
    """wq|wkv_a's output columns with every rotary part de-interleaved."""
    qk, rot = d.qk_nope + d.qk_rope, rot_order(d)
    heads = [torch.cat([torch.arange(d.qk_nope), d.qk_nope + rot]) + h * qk
             for h in range(d.n_heads)]
    return torch.cat(heads + [d.n_heads * qk + torch.cat(
        [torch.arange(d.kv_lora_rank), d.kv_lora_rank + rot])])


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half on x [n, ..., rope] (de-interleaved), cos/sin [n, rope
    / 2]."""
    h = x.shape[-1] // 2
    while cos.ndim < x.ndim:
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Reference:
    """The reference model of one DeepSeek-V2 configuration and seed.

    src: the raw weights (RawDeepseekV2: block, embeddings, head, gate and
    the profiles rms_m, rms_f, rms_e, rms_s); dims: the configuration's
    shapes (architectures/deepseek_v2.Dims); probes and base_rows: the
    bucket layout the configuration states."""

    def __init__(self, src, dims, probes: int = 4096, base_rows: int = 128):
        self.src, self.d = src, dims
        self.probes, self.base_rows = probes, base_rows
        self.pm = fx.calib_order(src.rms_m)
        self.hid = {"dense_": fx.calib_order(src.rms_f),
                    "": fx.calib_order(src.rms_e),
                    "shared_": fx.calib_order(src.rms_s)}
        self.qa = qa_order(dims).to(src.device)

    def _mat(self, wt: torch.Tensor) -> fx.Matrix:
        """wt quantized; its chunks base_rows long, or halved until they
        divide the rows (the dense w2's 10944: 64), as the layout states."""
        base = self.base_rows
        while wt.shape[0] % base and base % 2 == 0:
            base //= 2
        return fx.quantize(wt, self.probes, base)

    def attn_mats(self, l: int) -> tuple:
        """(wq|wkv_a, wo) of layer l quantized, and wkv_b [R, H, nope + v]
        in bf16."""
        s = self.src
        qa = torch.cat([s.block("wq", l), s.block("wkv_a", l)],
                       dim=1)[self.pm][:, self.qa]
        b = _bf16(s.block("wkv_b", l)).reshape(self.d.kv_lora_rank,
                                                self.d.n_heads, -1)
        return self._mat(qa), self._mat(s.block("wo", l)[:, self.pm]), b

    def ffn_mats(self, prefix: str, inst: int) -> tuple:
        """(w1|w3, w2) of one FFN instance quantized: prefix "dense_" (a
        leading dense layer), "" (a routed expert) or "shared_"."""
        s, p = self.src, self.hid[prefix]
        w13 = torch.cat([s.block(prefix + "w1", inst),
                         s.block(prefix + "w3", inst)], dim=1)[self.pm]
        w13 = w13[:, torch.cat([p, p + len(p)])]
        w2 = s.block(prefix + "w2", inst)[p][:, self.pm]
        return self._mat(w13), self._mat(w2)

    def _ffn(self, mats, X, effort, tau, rec):
        m13, m2 = mats
        h = fx.matmul(m13, X, effort, tau, rec("w13", m13))
        n = h.shape[1] // 2
        return fx.matmul(m2, torch.nn.functional.silu(h[:, :n]) * h[:, n:],
                         effort, tau, rec("w2", m2))

    def forward(self, seqs: list, want: list, effort: float, tau,
                work=None, follow: list = None, kv_err: list = None) -> list:
        """reference/model.py's forward for DeepSeek-V2. follow: for each
        sequence, the latent rows another pass wrote for it (a 1-tuple of
        [L, n, R + rope], any device and float type), or None: each
        position then attends to those rows for the positions before it
        and to its own at itself. kv_err then gets each layer's relative
        error of the pass's own rows against the given ones."""
        d, s = self.d, self.src
        dev = s.device
        lens = [len(q) for q in seqs]
        ids = torch.tensor([t for q in seqs for t in q], device=dev)
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        emb = _bf16(s.embeddings()[:, self.pm])
        X = emb[ids]
        del emb
        ones = torch.ones(d.dim, device=dev)
        ones_r = torch.ones(d.kv_lora_rank, device=dev)
        H, R, nope = d.n_heads, d.kv_lora_rank, d.qk_nope
        inv, msc = inv_freq(d, dev)
        ang = pos.float()[:, None] * inv
        cos, sin = torch.cos(ang) * msc, torch.sin(ang) * msc
        scale = softmax_scale(d)
        everyone = torch.arange(len(ids), device=dev)
        for l in range(d.n_layers):
            def rec(name, mat, idx=everyone, l=l):
                if work is None:
                    return None
                return lambda r: work(l, name, idx, mat.in_dim,
                                      mat.out_dim, r)
            mqa, mo, wkv_b = self.attn_mats(l)
            Xn = fx.rms_norm(X, ones, d.norm_eps)
            qa = fx.matmul(mqa, Xn, effort, tau, rec("wqkv", mqa))
            del mqa
            q = qa[:, :H * (nope + d.qk_rope)].reshape(-1, H, nope + d.qk_rope)
            q_nope, q_pe = q[..., :nope], rope(q[..., nope:], cos, sin)
            c = fx.rms_norm(qa[:, H * (nope + d.qk_rope):][:, :R], ones_r,
                            KV_NORM_EPS)
            k_pe = rope(qa[:, H * (nope + d.qk_rope) + R:], cos, sin)
            rows = _bf16(torch.cat([c, k_pe], dim=-1))     # as cached
            att, at, errs = [], 0, []
            for i, n in enumerate(lens):
                sl = slice(at, at + n)
                own = rows[sl]
                kept = own if follow is None else \
                    follow[i][0][l].to(dev).float()
                if follow is not None:
                    errs.append(_rel(own, kept))
                att.append(self._attend(q_nope[sl], q_pe[sl], kept, own,
                                        wkv_b, scale, follow is not None))
                at += n
            if kv_err is not None and errs:
                kv_err.append(torch.cat(errs))
            X = X + fx.matmul(mo, torch.cat(att), effort, tau,
                              rec("wo", mo))
            del mo, att, rows, wkv_b
            Fn = fx.rms_norm(X, ones, d.norm_eps)
            if l < d.first_dense:
                X = X + self._ffn(self.ffn_mats("dense_", l), Fn, effort,
                                  tau, rec)
            else:
                X = X + self._moe(l, Fn, effort, tau, rec)
        Xf = fx.rms_norm(X, ones, d.norm_eps)
        head = _bf16(s.head()[self.pm])
        out, at = [], 0
        for n, w in zip(lens, want):
            idx = torch.as_tensor(w, dtype=torch.long, device=dev) + at
            out.append(_bf16(Xf[idx]) @ head)
            at += n
        return out

    def _attend(self, q_nope, q_pe, rows, own, wkv_b, scale: float,
                follow: bool) -> torch.Tensor:
        """Causal attention of one sequence: every head's keys [W_UK c |
        k_pe] from the latent rows (bf16 values) against the query [q_nope
        | q_pe], q_nope rounded to bf16 (wkv_b's products take bf16 inputs,
        as the configuration states); the softmax's weights on the latents,
        that sum rounded to bf16 and through W_UV (the value W_UV c, summed
        after the product, as the configuration's absorbed form does).
        Query t sees rows[s] at s < t and its own row at t (the same rows
        when not following). Returns [n, H * v] f32."""
        R, nope = self.d.kv_lora_rank, self.d.qk_nope
        n = q_nope.shape[0]
        w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
        qn = _bf16(q_nope)

        def score(r, pairs):
            k_nope = torch.einsum("sr,rhd->shd", r[:, :R], w_uk)
            if pairs:
                return (torch.einsum("thd,thd->ht", qn, k_nope)
                        + torch.einsum("thd,td->ht", q_pe, r[:, R:]))
            return (torch.einsum("thd,shd->hts", qn, k_nope)
                    + torch.einsum("thd,sd->hts", q_pe, r[:, R:]))
        s = score(rows, False) * scale
        idx = torch.arange(n, device=q_nope.device)
        s = torch.where(idx[None, :] <= idx[:, None], s,
                        torch.full_like(s, -math.inf))
        if follow:
            s[:, idx, idx] = score(own, True) * scale
        p = torch.softmax(s, dim=-1)
        if follow:
            p_own = p[:, idx, idx].clone()             # [H, n]
            p[:, idx, idx] = 0.0
            lat = torch.einsum("hts,sr->thr", p, rows[:, :R]) \
                + p_own.T[..., None] * own[:, None, :R]
        else:
            lat = torch.einsum("hts,sr->thr", p, rows[:, :R])
        return torch.einsum("thr,rhd->thd", _bf16(lat), w_uv).reshape(n, -1)

    def route(self, m: int, X: torch.Tensor) -> tuple:
        """(gates [T, k], experts [T, k]) of MoE layer m: the top k of the
        softmax over every routed expert's logit (bf16 product, f32 sums),
        best first, ties to the lower expert; renormalised only when
        norm_topk_prob (routed_scaling_factor is 1, architectures/
        deepseek_v2.dims)."""
        gate = _bf16(self.src.gate(m)[self.pm])
        logits = _bf16(X) @ gate
        _, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        idx = idx[:, :self.d.top_k]
        g = torch.softmax(logits, dim=-1).gather(1, idx)
        if self.d.norm_topk_prob:
            g = g / g.sum(dim=-1, keepdim=True)
        return g, idx

    def _moe(self, l, X, effort, tau, rec):
        m, E = l - self.d.first_dense, self.d.n_experts
        gates, idx = self.route(m, X)
        out = torch.zeros_like(X)
        for e in range(E):
            hit = (idx == e)
            sel = hit.any(dim=1).nonzero()[:, 0]
            if not len(sel):
                continue
            y = self._ffn(self.ffn_mats("", m * E + e), X[sel], effort, tau,
                          lambda n, mt, sel=sel: rec(n, mt, sel))
            g = (gates[sel] * hit[sel]).sum(dim=1, keepdim=True)
            out.index_add_(0, sel, g * y)
        if self.d.n_shared:
            out = out + self._ffn(self.ffn_mats("shared_", m), X, effort,
                                  tau, rec)
        return out
