"""Rank bodies for multihost.spawn, importable by name in a spawned process:
one driver of every parallel mode's decode, and the small jobs the tests
run in the same ranks. The tests (gloo on the CPU) and chip_smoke.py's
`parallel` phase (ranks on the card) call run_jobs.

A decode job (a dict) names a mode ("tp", "sp", "ep", "pp", "tp_ep",
"tp_sp"), its axis size n (a pair for the 2D modes), the global config and
bucket config, where its weights come from (("numpy", d): a JAX global
sharded model carried across by parallel_weights_from_numpy; ("seed", s):
the port's make_*_weights(rank=r)), the impl, an optional cache fill, and
runs: each feeds its tokens one by one from slot `start` (pp: one list a
microbatch) and then n_new greedy tokens, recording the logits of every
step, the K1 launches, and the host seconds.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from effort_tpu_torch.kernels import LAUNCHES, fused_stream, launches_since
from effort_tpu_torch.models.bridge import parallel_weights_from_numpy
from effort_tpu_torch.models.transformer import (forward_seq, forward_token,
                                                 make_kv_cache, route)
from effort_tpu_torch.ops import bucketmul
from effort_tpu_torch.ops.effort import effort_q16
from effort_tpu_torch.parallel import (collectives, composed, ep,
                                       multihost, pp, sp, tp)


def fill_rows(cfg, n_slots: int, seed: int, device):
    """Seeded bf16 K and V rows [L, n_slots, KV, D], the same in every
    process on one device type: the stand-in for a long prompt's cache."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shape = (cfg.n_layers, n_slots, cfg.n_kv_heads, cfg.head_dim)
    return tuple(torch.randn(shape, generator=g, device=device).to(
        torch.bfloat16) for _ in range(2))


def tokens_input(cfg, T: int, seed: int, device) -> torch.Tensor:
    """Seeded FFN inputs [T, dim] f32 (unit scale, as after the norm), the
    same in every process on one device type."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((T, cfg.dim), generator=g, device=device)


def local_config(mode: str, cfg, n):
    return {"tp": lambda: tp.local_config(cfg, n),
            "sp": lambda: cfg,
            "ep": lambda: ep.local_config(cfg, n),
            "pp": lambda: pp.local_config(cfg, n),
            "tp_ep": lambda: composed.tp_ep_local_config(cfg, *n),
            "tp_sp": lambda: tp.local_config(cfg, n[0])}[mode]()


def mode_mesh(mode: str, n, device):
    return {"tp": lambda: tp.make_mesh(1, n, device),
            "sp": lambda: sp.make_sp_mesh(n, device),
            "ep": lambda: ep.make_ep_mesh(n, device),
            "pp": lambda: pp.make_pp_mesh(n, device),
            "tp_ep": lambda: composed.make_tp_ep_mesh(*n, device),
            "tp_sp": lambda: composed.make_tp_sp_mesh(*n, device)}[mode]()


def rank_weights(job: dict, rank: int, device):
    """(this rank's weights, its local config)."""
    mode, n, cfg, bcfg = job["mode"], job["n"], job["cfg"], job["bcfg"]
    kind, src = job["weights"]
    if kind == "numpy":
        w = parallel_weights_from_numpy(src, mode, n, rank).to(device)
        return w, local_config(mode, cfg, n)
    build = {
        "tp": lambda: tp.make_tp_weights(cfg, bcfg, n, src, rank=rank,
                                         device=device),
        "sp": lambda: (tp.make_tp_weights(cfg, bcfg, 1, src, rank=0,
                                          device=device)[0], cfg),
        "ep": lambda: ep.make_ep_weights(cfg, bcfg, n, src, rank=rank,
                                         device=device),
        "pp": lambda: pp.make_pp_weights(cfg, bcfg, n, src, rank=rank,
                                         device=device),
        "tp_ep": lambda: composed.make_tp_ep_weights(
            cfg, bcfg, n[0], n[1], src, rank=rank, device=device),
        "tp_sp": lambda: tp.make_tp_weights(cfg, bcfg, n[0], src,
                                            rank=rank // n[1],
                                            device=device)}
    return build[mode]()


def global_caches(job: dict, device):
    """The whole model's (k, v) caches [L, S, KV, D], zeros past the fill
    (job["fill"] = (slots, seed))."""
    cfg = job["cfg"]
    k, v = make_kv_cache(cfg, device)
    if job.get("fill"):
        slots, seed = job["fill"]
        fk, fv = fill_rows(cfg, slots, seed, device)
        k[:, :slots] = fk
        v[:, :slots] = fv
    return k, v


def rank_caches(job: dict, rank: int, cfg_l, device):
    """This rank's part of the global caches (pp: its stage's [L_loc, M,
    S, KV, D], empty)."""
    mode, n = job["mode"], job["n"]
    if mode == "pp":
        return pp.make_pp_caches(cfg_l, n, device)
    KV = job["cfg"].n_kv_heads

    def local(c):
        if mode == "tp":
            return c[:, :, tp.span(KV, n, rank)].clone()
        if mode == "sp":
            return sp.sp_cache_local(c, n, rank)
        if mode == "tp_ep":
            return c[:, :, tp.span(KV, n[0], rank // n[1])].clone()
        if mode == "tp_sp":
            return composed.tp_sp_cache_local(c, n[0], n[1], rank)
        return c
    return tuple(local(c) for c in global_caches(job, device))


def stepper(job: dict, w, cfg_l, mesh):
    """step(tokens, pos, k_cache, v_cache, effort) -> logits of the mode:
    [vocab], or for pp [M, vocab] from M tokens and positions."""
    mode, n, impl, cfg = job["mode"], job["n"], job["impl"], job["cfg"]
    if mode == "pp":
        return lambda t, p, kc, vc, e: pp.pp_decode_step(
            w, cfg_l, t, p, kc, vc, e, impl, n, mesh)
    return {
        "tp": lambda t, p, kc, vc, e: tp.tp_forward_token(
            w, cfg_l, t[0], p[0], kc, vc, e, impl, mesh),
        "sp": lambda t, p, kc, vc, e: sp.sp_forward_token(
            w, cfg, t[0], p[0], kc, vc, e, impl, n, mesh),
        "ep": lambda t, p, kc, vc, e: ep.ep_forward_token(
            w, cfg_l, t[0], p[0], kc, vc, e, impl, n, mesh),
        "tp_ep": lambda t, p, kc, vc, e: composed.tp_ep_forward_token(
            w, cfg_l, t[0], p[0], kc, vc, e, impl, n[1], mesh),
        "tp_sp": lambda t, p, kc, vc, e: composed.tp_sp_forward_token(
            w, cfg_l, t[0], p[0], kc, vc, e, impl, n[1], mesh),
    }[mode]


def _effort(effort: float, device):
    """The kernels' 16.16 effort on the card, made once a run (a CUDA
    tensor made from a python number waits for the card); the float on
    the CPU."""
    return effort_q16(effort, device) if device.type == "cuda" else effort


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_run(step, run: dict, caches, device, keep_logits: bool) -> dict:
    """Feed each sequence's tokens from slot run["start"], then n_new
    greedy tokens (the argmax of the step before); run["device_pos"]
    passes the positions as int32 device tensors, run["tau"] sets K1's
    coverage target for the run, run["record_routing"] keeps the experts
    ep_ffn routes each token to ([steps, layers, k]). Returns the fed tokens
    (one list a sequence), the logits of every step [steps, (M,) vocab] f32
    (when kept), the step count, host seconds and the launches."""
    seqs = run["tokens"]
    pipelined = isinstance(seqs[0], (list, tuple))
    seqs = [list(s) for s in (seqs if pipelined else [seqs])]
    start, n_new = run.get("start", 0), run.get("n_new", 0)
    steps = max(len(s) for s in seqs) + n_new
    eff = _effort(run["effort"], device)
    fed, logits = [[] for _ in seqs], []
    tau, route0, routing = fused_stream._TAU, ep.route, []
    fused_stream._TAU = run.get("tau", tau)
    if run.get("record_routing"):
        def recorded(*args):
            gates, idx = route0(*args)
            routing.append(idx)
            return gates, idx
        ep.route = recorded
    sync(device)
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    try:
        _feed(step, seqs, start, steps, run.get("device_pos"), caches, eff,
              device, fed, logits if keep_logits else None)
    finally:
        fused_stream._TAU, ep.route = tau, route0
    sync(device)
    out = dict(fed=fed if pipelined else fed[0], steps=steps,
               seconds=time.perf_counter() - t0,
               launches=launches_since(before), effort=run["effort"])
    if keep_logits:
        out["logits"] = np.stack(logits)
    if routing:
        out["routing"] = torch.stack(routing).reshape(
            steps, -1, routing[0].shape[-1]).cpu().numpy()
    return out


def _feed(step, seqs, start, steps, device_pos, caches, eff, device, fed,
          logits) -> None:
    """decode_run's loop: appends each step's tokens to fed and, unless
    logits is None, its logits."""
    last = None
    for t in range(steps):
        toks = [s[t] if t < len(s) else int(last[m].argmax())
                for m, s in enumerate(seqs)]
        for m, x in enumerate(toks):
            fed[m].append(x)
        pos = [start + t] * len(seqs)
        if device_pos:
            pos = torch.tensor(pos, dtype=torch.int32, device=device)
        lg = step(toks, pos, *caches, eff)
        last = lg.reshape(len(seqs), -1)
        if logits is not None:
            logits.append(lg.float().cpu().numpy())


def same_input_gate(step_once) -> dict:
    """step_once() with every K1 call also run through K1's plain version
    on the very inputs and instance it was given: the least cosine, the
    largest max|dy| / max|y_ref|, and whether every streamed length C
    matched (chip_smoke's kernel gate: >= 0.9999, <= 1e-2, all)."""
    k1, rows = bucketmul.mxu_matvec, []

    def both(bm, v, effort, expert=0, tau=None):
        y, C = k1(bm, v, effort, expert, tau, return_len=True)
        yr, Cr = fused_stream.mxu_matvec_ref(bm, v, effort, expert, tau,
                                             return_len=True)
        rows.append(torch.stack([
            torch.nn.functional.cosine_similarity(y.double(), yr.double(),
                                                  dim=0),
            (y - yr).abs().max().double()
            / yr.abs().max().double().clamp(min=1e-30),
            (C == Cr).all().double()]))
        return y
    bucketmul.mxu_matvec = both
    try:
        step_once()
    finally:
        bucketmul.mxu_matvec = k1
    if not rows:
        return dict(calls=0)
    r = torch.stack(rows).cpu()
    return dict(calls=len(rows), min_cos=float(r[:, 0].min()),
                max_rel_err=float(r[:, 1].max()),
                c_equal=bool(r[:, 2].all()))


def decode_job(job: dict, rank: int, device) -> dict:
    """Build this rank's weights and caches for job["mode"], run its
    runs (and job["ffn_tokens"] cases: ep_ffn_tokens on this rank's share
    of seeded or given tokens), and report."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    mesh = mode_mesh(job["mode"], job["n"], device)
    w, cfg_l = rank_weights(job, rank, device)
    caches = rank_caches(job, rank, cfg_l, device)
    sync(device)
    out = dict(mode=job["mode"], rank=rank, build_s=time.perf_counter() - t0)
    step = stepper(job, w, cfg_l, mesh)
    keep = job.get("all_ranks", True) or rank == 0
    if job.get("gate"):
        first = job["runs"][0]
        toks = first["tokens"]
        toks = ([s[0] for s in toks] if isinstance(toks[0], (list, tuple))
                else [toks[0]])
        start = first.get("start", 0)
        gate_caches = tuple(c.clone() for c in caches)
        out["gate"] = same_input_gate(lambda: step(
            toks, [start] * len(toks), *gate_caches,
            _effort(job["gate"], device)))
        del gate_caches
    out["runs"] = [decode_run(step, r, caches, device, keep)
                   for r in job["runs"]]
    out["ffn_tokens"] = [ffn_tokens_case(job, c, w, cfg_l, mesh, rank,
                                         device)
                         for c in job.get("ffn_tokens", ())]
    if job.get("return_cache"):
        out["cache"] = [c.float().cpu().numpy() for c in caches]
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del w, caches, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ffn_tokens_case(job: dict, case: dict, w, cfg_l, mesh, rank: int,
                    device) -> dict:
    """One ep_ffn_tokens call on this rank's share of the tokens: case["X"]
    a global [T, dim] array, or ("seed", s, T); zero_gate routes every
    token to the first experts (all gate logits tie)."""
    n, cfg = job["n"], job["cfg"]
    X = case["X"]
    X = (tokens_input(cfg, X[2], X[1], device) if isinstance(X, tuple)
         else torch.as_tensor(X, device=device))
    Tl = X.shape[0] // n
    X_loc = X[rank * Tl:(rank + 1) * Tl].contiguous()
    layer = w.layers
    if case.get("zero_gate"):
        layer = dataclasses.replace(layer,
                                    ffn_gate=torch.zeros_like(layer.ffn_gate))
    l = case["layer"]
    sync(device)
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    y, dropped = ep.ep_ffn_tokens(
        layer, l, X_loc, _effort(case.get("effort", 1.0), device), cfg_l, n,
        job["impl"], mesh, capacity_factor=case["capacity_factor"],
        return_stats=True)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launches_since(before)
    _, idx = route(layer, l, X_loc, cfg)
    return dict(y=y.cpu().numpy(), dropped=int(dropped.item()),
                experts=idx.cpu().numpy(), seconds=seconds,
                launches=launches, tokens=Tl)


def hooks_job(job: dict, rank: int, device) -> dict:
    """The transformer's tp and ffn_fn hooks over a 1-rank tp group (a
    (world, 1) ("dp", "tp") mesh) against no hook: forward_token and
    forward_seq, dense and MoE; True where the logits and caches are
    equal bit for bit."""
    cfg, bcfg, impl = job["cfg"], job["bcfg"], job["impl"]
    world = torch.distributed.get_world_size()
    mesh = tp.make_mesh(world, 1, device)
    w, _ = tp.make_tp_weights(cfg, bcfg, 1, job["seed"], rank=0,
                              device=device)
    toks = torch.as_tensor(job["tokens"], device=device)
    out = {}
    for name, kw in (("tp", dict(tp=(mesh, "tp"))),
                     ("ffn_fn", dict(ffn_fn=_plain_ffn(cfg, impl)))):
        got = []
        for hook in (kw, {}):
            kc, vc = make_kv_cache(cfg, device)
            lg = [forward_token(w, cfg, int(t), p, kc, vc, effort=0.5,
                                impl=impl, **hook)
                  for p, t in enumerate(job["tokens"])]
            got.append((torch.stack(lg), kc, vc))
        out["forward_token_" + name] = all(
            torch.equal(a, b) for a, b in zip(*got))
    seq = []
    for hook in (dict(tp=(mesh, "tp")), {}):
        kc, vc = make_kv_cache(cfg, device)
        seq.append((forward_seq(w, cfg, toks, kc, vc, effort=0.5,
                                impl=impl, **hook), kc, vc))
    out["forward_seq_tp"] = all(torch.equal(a, b) for a, b in zip(*seq))
    return out


def _plain_ffn(cfg, impl):
    """An ffn_fn that is the model's own FFN (the hook's identity case)."""
    from effort_tpu_torch.models.transformer import _ffn, proj_efforts

    def ffn(layer, l, x):
        return _ffn(layer, l, x, proj_efforts(0.5, cfg), cfg, impl)
    return ffn


def collectives_job(job: dict, rank: int, device) -> dict:
    """Each collectives helper on a 1D mesh of every rank, on rank r's
    row of the given global arrays."""
    world = torch.distributed.get_world_size()
    mesh = sp.make_sp_mesh(world, device)
    x = torch.as_tensor(job["x"][rank], device=device)
    a2a = torch.as_tensor(job["a2a"][rank], device=device)
    return dict(
        axis_index=collectives.axis_index(mesh, "sp"),
        psum=collectives.psum(x, mesh, "sp").cpu().numpy(),
        pmax=collectives.pmax(x, mesh, "sp").cpu().numpy(),
        all_gather=collectives.all_gather(x, mesh, "sp").cpu().numpy(),
        all_gather_stacked=collectives.all_gather(
            x, mesh, "sp", tiled=False).cpu().numpy(),
        all_to_all=collectives.all_to_all(a2a, mesh, "sp").cpu().numpy(),
        all_to_all_1_0=collectives.all_to_all(
            a2a, mesh, "sp", split_axis=1, concat_axis=0).cpu().numpy(),
        ppermute=collectives.ppermute(x, mesh, "sp",
                                      job["perm"]).cpu().numpy(),
        x_unchanged=bool(torch.equal(
            x, torch.as_tensor(job["x"][rank], device=device))))


def pod_mesh_job(job: dict, rank: int, device) -> dict:
    """make_pod_mesh's rank array for each (dcn, ici) case, and a psum over
    "tp" of rank r's entry of job["x"] on the first case's mesh."""
    out = dict(ranks=[])
    for dcn, ici in job["cases"]:
        m = multihost.make_pod_mesh(("dp", "tp"), dcn, ici,
                                    n_hosts=job["n_hosts"],
                                    device_type=torch.device(device).type)
        out["ranks"].append(m.mesh.numpy())
        if "psum" not in out:
            out["shape"] = tuple(m.mesh.shape)
            v = torch.tensor([float(np.asarray(job["x"]).reshape(-1)[rank])],
                             device=device)
            out["psum"] = float(collectives.psum(v, m, "tp")[0])
    return out


_KINDS = {"decode": decode_job, "hooks": hooks_job,
          "collectives": collectives_job, "pod_mesh": pod_mesh_job}


def run_jobs(rank: int, world: int, device, jobs: list) -> list:
    """multihost.spawn's body: each job in turn, by job["kind"] (default
    "decode")."""
    return [_KINDS[j.get("kind", "decode")](j, rank, device) for j in jobs]


def loaded_modules(rank: int, world: int, device, roots) -> list:
    """The modules under `roots` (top-level names) loaded in this rank."""
    import sys
    return sorted(m for m in sys.modules if m.split(".")[0] in roots)


def fail_on(rank: int, world: int, device, bad_rank: int) -> int:
    """A body that raises on one rank (spawn's failure path)."""
    if rank == bad_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank
