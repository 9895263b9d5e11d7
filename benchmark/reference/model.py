"""The plain forward pass of the Mistral / Mixtral decoder, in f32, over
whole token sequences (teacher-forced), a layer at a time.

It follows the published architecture (RMS norm, rotary embeddings,
grouped-query attention, SiLU-gated FFN, and for Mixtral a top-k router
whose softmax weights the chosen experts), with the precisions that the
configuration states: embeddings, head and router weights in bf16, the
projections as the frozen effort arithmetic of reference.effort on int8
codes (the activations they take rounded to bf16, as the selection
states), keys and values rounded to bf16 as the cache holds them; every
sum and everything else in f32 with TF32 off.

Each layer's matrices are rebuilt from the raw blocks (`src`, the
benchmark's RawModel) when the layer is reached and dropped after it, so
the pass fits beside nothing else on the card. It imports nothing of the
program.
"""

from __future__ import annotations

import torch

from reference import effort as fx


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative error of each row of a against b ([n, ...] -> [n])."""
    d = (a - b).flatten(1).norm(dim=1)
    return d / b.flatten(1).norm(dim=1).clamp(min=1e-30)


class Reference:
    """The reference model of one configuration and seed.

    src: the raw weights (RawModel: block, embeddings, head, gate, rms_m,
    rms_f); dims: the configuration's shapes; probes and base_rows: the
    bucket layout the configuration states."""

    def __init__(self, src, dims, probes: int = 4096, base_rows: int = 128):
        self.src, self.d = src, dims
        self.probes, self.base_rows = probes, base_rows
        self.pm = fx.calib_order(src.rms_m)
        self.pf = fx.calib_order(src.rms_f)
        self.p13 = torch.cat([self.pf, self.pf + dims.hidden])

    def _mat(self, wt: torch.Tensor) -> fx.Matrix:
        return fx.quantize(wt, self.probes, self.base_rows)

    def attn_mats(self, l: int) -> tuple:
        s = self.src
        qkv = torch.cat([s.block("wq", l), s.block("wk", l),
                         s.block("wv", l)], dim=1)[self.pm]
        return self._mat(qkv), self._mat(s.block("wo", l)[:, self.pm])

    def ffn_mats(self, inst: int) -> tuple:
        s = self.src
        w13 = torch.cat([s.block("w1", inst), s.block("w3", inst)],
                        dim=1)[self.pm][:, self.p13]
        w2 = s.block("w2", inst)[self.pf][:, self.pm]
        return self._mat(w13), self._mat(w2)

    def _ffn(self, mats, X, effort, tau, rec):
        m13, m2 = mats
        h = fx.matmul(m13, X, effort, tau, rec("w13", m13))
        x1, x3 = h[:, :self.d.hidden], h[:, self.d.hidden:]
        return fx.matmul(m2, torch.nn.functional.silu(x1) * x3, effort,
                         tau, rec("w2", m2))

    def forward(self, seqs: list, want: list, effort: float, tau,
                work=None, follow: list = None, kv_err: list = None) -> list:
        """seqs: token id lists, each one sequence from position 0; want:
        for each, the positions whose logits are returned. Returns a list
        of [len(want[i]), vocab] f32 logits. tau: the coverage of each
        product's prefix (None: every selected row). work, when given, is
        called for every product as work(layer, matrix name, token
        indices [n] into the concatenated sequences, in_dim, out_dim,
        rows [n]): the rows each token's product needs.

        follow: for each sequence, the keys and values another pass wrote
        for it ([L, n, KV, D] each, any device and float type), or None:
        then every position attends to those rows for the positions
        before it and to its own at itself, so each position is one step
        from that pass's state (else the pass attends to its own keys and
        values throughout). kv_err, a list, then gets each layer's
        relative error of the pass's own key and value rows against the
        given ones, a tensor a layer (keys, then values, of each
        sequence in turn)."""
        d, s = self.d, self.src
        dev = s.device
        lens = [len(q) for q in seqs]
        ids = torch.tensor([t for q in seqs for t in q], device=dev)
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        emb = _bf16(s.embeddings()[:, self.pm])
        X = emb[ids]
        del emb
        ones = torch.ones(d.dim, device=dev)
        H, KV, D = d.n_heads, d.n_kv_heads, d.head_dim
        everyone = torch.arange(len(ids), device=dev)
        for l in range(d.n_layers):
            def rec(name, mat, idx=everyone, l=l):
                if work is None:
                    return None
                return lambda r: work(l, name, idx, mat.in_dim,
                                      mat.out_dim, r)
            mqkv, mo = self.attn_mats(l)
            Xn = fx.rms_norm(X, ones, d.norm_eps)
            qkv = fx.matmul(mqkv, Xn, effort, tau, rec("wqkv", mqkv))
            del mqkv
            Q = fx.rope(qkv[:, :H * D].reshape(-1, H, D), pos, d.rope_theta)
            K = _bf16(fx.rope(qkv[:, H * D:(H + KV) * D].reshape(-1, KV, D),
                              pos, d.rope_theta))
            V = _bf16(qkv[:, (H + KV) * D:].reshape(-1, KV, D))
            att, at, errs = [], 0, []
            for i, n in enumerate(lens):
                sl = slice(at, at + n)
                if follow is None:
                    att.append(fx.attention(Q[sl], K[sl], V[sl], pos[sl],
                                            pos[sl], KV))
                else:
                    Kp = follow[i][0][l].to(dev).float()
                    Vp = follow[i][1][l].to(dev).float()
                    att.append(fx.attention_follow(Q[sl], K[sl], V[sl], Kp,
                                                   Vp, KV))
                    errs.append(_rel(K[sl], Kp))
                    errs.append(_rel(V[sl], Vp))
                at += n
            if kv_err is not None and errs:
                kv_err.append(torch.cat(errs))
            X = X + fx.matmul(mo, torch.cat(att), effort, tau,
                              rec("wo", mo))
            del mo, Q, K, V, att
            Fn = fx.rms_norm(X, ones, d.norm_eps)
            if d.n_experts == 1:
                X = X + self._ffn(self.ffn_mats(l), Fn, effort, tau, rec)
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

    def route(self, l: int, X: torch.Tensor) -> tuple:
        """(gates [T, k], experts [T, k]): the softmax of the top-k router
        logits (bf16 product, f32 sums), best first, ties to the lower
        expert."""
        gate = _bf16(self.src.gate(l)[self.pm])
        logits = _bf16(X) @ gate
        top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        k = self.d.top_k
        return torch.softmax(top[:, :k], dim=-1), idx[:, :k]

    def _moe(self, l, X, effort, tau, rec):
        gates, idx = self.route(l, X)
        out = torch.zeros_like(X)
        for e in range(self.d.n_experts):
            hit = (idx == e)
            sel = hit.any(dim=1).nonzero()[:, 0]
            if not len(sel):
                continue
            y = self._ffn(self.ffn_mats(l * self.d.n_experts + e), X[sel],
                          effort, tau,
                          lambda n, m, sel=sel: rec(n, m, sel))
            g = (gates[sel] * hit[sel]).sum(dim=1, keepdim=True)
            out.index_add_(0, sel, g * y)
        return out
