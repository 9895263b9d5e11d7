"""The port's trainer (effort_tpu_torch/train) against the JAX package's
(effort_tpu/train) on the CPU.

The JAX trainer's own tests (tests/test_train.py) run first on the port:
shapes and a finite loss near ln V, the trained function equal to the
served one after export -> convert -> load, loss descent, the byte
corpus, and MoE forward parity. Then each part against JAX on the same
parameters (JAX's init, carried across as numpy through
models/bridge.train_params_from_numpy): forward logits and aux (dense,
MoE, sliding window), the loss and its gradients, the optax schedule and
clip, three optimizer steps through the optax chain of the JAX trainer
(mu in f32 and bf16), export_hf byte for byte, and train's step counts
(overshoot, clamps, deadline). Tiny model: 2 layers, vocab 256.
"""

import dataclasses
import math
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.train import trainer as jt
from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.models.bridge import (train_params_from_numpy,
                                            train_params_to_numpy)
from effort_tpu_torch.train import (TrainConfig, byte_corpus_from_files,
                                    export_hf, forward, init_params,
                                    next_token_loss, train)
from effort_tpu_torch.train import optim
from effort_tpu_torch.train import trainer as pt

torch.set_num_threads(2)

V = 256
CASES = {"dense": {}, "moe": dict(n_experts=4, n_experts_per_tok=2),
         "window": dict(sliding_window=5)}


def _cfg(**kw):
    return dataclasses.replace(tiny_test_model(), vocab_size=V, n_layers=2,
                               **kw)


def _jcfg(**kw):
    return dataclasses.replace(jax_tiny(), vocab_size=V, n_layers=2, **kw)


def _carried(seed: int, **kw):
    """(JAX cfg, JAX params, port cfg, the same params in the port)."""
    jc = _jcfg(**kw)
    jp = jt.init_params(jc, seed=seed)
    return jc, jp, _cfg(**kw), train_params_from_numpy(
        jax.tree.map(np.asarray, jp))


def _toks(seed: int, shape=(2, 16)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, V, shape).astype(
        np.int32)


def _close(got, want, rel: float, what=""):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# ---- JAX's own trainer tests (tests/test_train.py), on the port ----------

def test_forward_shapes_and_loss_finite():
    cfg = _cfg()
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_toks(0))
    logits, aux = forward(params, cfg, toks)
    assert logits.shape == (2, 16, V) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0
    loss = float(next_token_loss(params, cfg, toks))
    # random init: loss ~= ln(vocab)
    assert math.isfinite(loss) and abs(loss - math.log(V)) < 1.0
    shapes = jax.tree.map(lambda a: a.shape,
                          jt.init_params(_jcfg(n_experts=4), seed=0))
    got = init_params(_cfg(n_experts=4), seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
    assert all(t.dtype == torch.float32 for t in pt.leaves(got))


def _served_logits(w, cfg, toks):
    from effort_tpu_torch.models.transformer import (forward_token,
                                                     make_kv_cache)
    kc, vc = make_kv_cache(cfg, "cpu")
    return [forward_token(w, cfg, tok, t, kc, vc, effort=1.0,
                          impl="reference").numpy()
            for t, tok in enumerate(toks)]


def _assert_served(served, ref):
    """cos > 0.999 at every position, and the same argmax wherever the
    trainer's top-two margin exceeds 0.05 (bf16 bucket rounding moves
    near-flat random-init logits; trained ones have decisive margins)."""
    for t, (a, b) in enumerate(zip(served, ref)):
        assert _cos(a, b) > 0.999, (t, _cos(a, b))
        srt = np.sort(b)
        if srt[-1] - srt[-2] > 0.05:
            assert int(np.argmax(a)) == int(np.argmax(b)), t


def test_forward_parity_with_inference_stack(tmp_path):
    """Trainer forward logits == inference forward_token logits after the
    port's export_hf -> convert_checkpoint -> load_bucketized (effort
    1.0, bf16 bucket rounding)."""
    from effort_tpu_torch.convert.convert import convert_checkpoint
    from effort_tpu_torch.models.weights import load_bucketized

    cfg = _cfg()
    params = init_params(cfg, seed=3, device="cpu")
    export_hf(params, cfg, str(tmp_path / "hf"))
    convert_checkpoint(str(tmp_path / "hf"), str(tmp_path / "b"), cfg,
                       BucketConfig(bucket_size=4, chunk_rows=8),
                       progress=lambda *a: None, device="cpu")
    w, cfg2, _ = load_bucketized(str(tmp_path / "b"), device="cpu",
                                 hbm_budget_bytes=1 << 30)
    toks = [5, 250, 17, 99, 3]
    ref = forward(params, cfg, torch.tensor([toks]))[0][0].numpy()
    _assert_served(_served_logits(w, cfg2, toks), ref)


def test_train_reduces_loss():
    """A few dozen steps on highly regular data must cut the loss well
    below the random-init ln(V)."""
    cfg = _cfg()
    pattern = np.tile(np.arange(64, dtype=np.uint8) % 17 + 40, 400)
    tcfg = TrainConfig(batch=8, seq_len=32, steps=60, warmup=10,
                       lr=1e-3, scan_chunk=20, holdout_frac=0.05)
    params, hist = train(cfg, pattern, tcfg, progress=lambda *a: None,
                         device="cpu")
    first, last = hist[0][1], hist[-1][1]
    assert last < first * 0.5, hist
    assert hist[-1][2] < np.log(cfg.vocab_size) * 0.5, hist  # holdout too


def test_byte_corpus_from_files(tmp_path):
    p1, p2 = tmp_path / "a.txt", tmp_path / "b.txt"
    p1.write_bytes(b"hello world")
    p2.write_bytes(b"goodbye")
    c = byte_corpus_from_files([str(p1), str(p2)])
    assert c.dtype == np.uint8 and len(c) == 18
    c2 = byte_corpus_from_files([str(p1), str(p2)], limit_bytes=11)
    assert len(c2) == 11
    c3 = byte_corpus_from_files([str(tmp_path / "none"), str(p2)])
    np.testing.assert_array_equal(
        c3, jt.byte_corpus_from_files([str(tmp_path / "none"), str(p2)]))


def test_moe_forward_parity():
    """Trainer MoE forward (dense all-experts, top-2 gated) must match
    the serving MoE path (route + _ffn, top-2 sparse) through the
    in-memory assembly (params_to_raw -> assemble_weights)."""
    from effort_tpu_torch.models.transformer import assemble_weights
    cfg = _cfg(n_experts=4, n_experts_per_tok=2)
    params = init_params(cfg, seed=5, device="cpu")
    w = assemble_weights(pt.params_to_raw(params, cfg), cfg,
                         BucketConfig(bucket_size=4, chunk_rows=8))
    toks = [5, 250, 17, 99]
    ref = forward(params, cfg, torch.tensor([toks]))[0][0].numpy()
    for t, (a, b) in enumerate(zip(_served_logits(w, cfg, toks), ref)):
        assert _cos(a, b) > 0.999, (t, _cos(a, b))


# ---- against JAX on the same parameters ----------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    """Logits within 1e-5 of their largest magnitude (f32 products in
    another order), the aux term within 1e-6 relative."""
    jc, jp, tc, tp = _carried(1, **CASES[case])
    toks = _toks(2)
    jl, ja = jt.forward(jp, jc, jnp.asarray(toks))
    tl, ta = forward(tp, tc, torch.from_numpy(toks))
    _close(tl.numpy(), jl, 1e-5, "logits")
    assert abs(float(ta) - float(ja)) <= 1e-6 * max(1.0, abs(float(ja)))
    if case == "moe":
        assert 0.0 < float(ta) < 4.0
    with torch.no_grad():                      # the path without remat
        _close(forward(tp, tc, torch.from_numpy(toks))[0].numpy(), jl,
               1e-5, "no-grad logits")


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_loss_and_grads_match_jax(case):
    """next_token_loss within 1e-6 relative; each gradient leaf within
    2e-5 of its largest magnitude (jax.value_and_grad against autograd
    through the recomputed layers); the global norms within 1e-5."""
    jc, jp, tc, tp = _carried(4, **CASES[case])
    toks = _toks(5, (2, 17))
    lj, gj = jax.value_and_grad(jt.next_token_loss)(jp, jc,
                                                    jnp.asarray(toks))
    ps = pt.leaves(tp)
    for p in ps:
        p.requires_grad_(True)
    lt = next_token_loss(tp, tc, torch.from_numpy(toks))
    gt = torch.autograd.grad(lt, ps)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * float(lj)
    gjl = jax.tree.leaves(gj)
    assert len(gjl) == len(gt)
    for a, b in zip(gjl, gt):
        assert tuple(b.shape) == a.shape
        _close(b.numpy(), a, 2e-5, a.shape)
    nj = float(optax.global_norm(gj))
    assert abs(float(optim.global_norm(list(gt))) - nj) <= 1e-5 * nj


@pytest.mark.parametrize("lr,warmup,steps", [(3e-4, 10, 60), (1e-2, 0, 5),
                                             (0.0, 2, 4)])
def test_schedule_matches_optax(lr, warmup, steps):
    """warmup_cosine_decay against optax.warmup_cosine_decay_schedule(0,
    lr, warmup, steps, 0.1 lr) at 0, through the warmup, mid-cosine, at
    the end and past it (held at 0.1 lr), within 1e-6 relative (f32)."""
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                               lr * 0.1)
    counts = sorted({0, 1, max(0, warmup - 1), warmup,
                     (warmup + steps) // 2, steps - 1, steps, steps + 7})
    got = optim.warmup_cosine_decay(
        torch.tensor(counts, dtype=torch.int32), lr, warmup, steps,
        lr * 0.1)
    want = np.array([float(sched(jnp.int32(c))) for c in counts])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got[0]) == 0.0 or warmup == 0
    assert float(got[-1]) == pytest.approx(lr * 0.1, rel=1e-6)


@pytest.mark.parametrize("scale", [0.2, 1.0, 5.0])
def test_clip_matches_optax(scale):
    """clip_by_global_norm against optax's: unchanged below the limit,
    g / norm * limit at and above it, within 1 ulp-scale (1e-6 relative);
    no epsilon in the denominator (torch's clip_grad_norm_ adds 1e-6)."""
    rng = np.random.default_rng(7)
    gs = [rng.standard_normal(s).astype(np.float32)
          for s in ((3, 4), (5,), (2, 2, 2))]
    norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                         for g in gs))
    gs = [g * np.float32(scale / norm) for g in gs]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in gs]
    n = optim.clip_by_global_norm(got, 1.0)
    assert float(n) == pytest.approx(scale, rel=1e-6)
    for a, b, g in zip(got, want, gs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
        if scale < 1.0:
            np.testing.assert_array_equal(a.numpy(), g)


def _optax_chain(tcfg):
    """The JAX trainer's optimizer (effort_tpu/train/trainer.py:250-255)."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, tcfg.lr, tcfg.warmup, tcfg.steps, tcfg.lr * 0.1)
    return optax.chain(
        optax.clip_by_global_norm(tcfg.clip_norm),
        optax.adamw(sched, weight_decay=tcfg.weight_decay,
                    mu_dtype=jnp.dtype(tcfg.mu_dtype)))


TCFG3 = TrainConfig(batch=2, seq_len=17, steps=3, warmup=1, lr=1e-2,
                    scan_chunk=3)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_same_grads_matches_optax(mu_dtype):
    """Three updates of the port's AdamW and optax's chain on the same
    gradients (norms 0.5, 3 and 1.5: clipped at the second): the first
    update has lr 0 and leaves every parameter as it was (decay too);
    then parameters within 1e-3 lr, moments within 1e-6 relative, the
    count 3. With mu in bf16 the clip's norm, summed in another order,
    can move an f32 moment lying at a bf16 rounding boundary to the other
    side: the stored moments agree within one bf16 ulp (2^-8 relative),
    and such an element's update by up to 2^-8 lr a step, so parameters
    within 1e-2 lr."""
    tcfg = dataclasses.replace(TCFG3, mu_dtype=mu_dtype)
    jc, jp, tc, tp = _carried(8, **CASES["moe"])
    opt = _optax_chain(tcfg)
    js = opt.init(jp)
    ps = pt.leaves(tp)
    st = optim.adamw_init(ps, mu_dtype)
    rng = np.random.default_rng(9)
    for i, gnorm in enumerate((0.5, 3.0, 1.5)):
        gs = [rng.standard_normal(p.shape).astype(np.float32) for p in ps]
        total = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                              for g in gs))
        gs = [g * np.float32(gnorm / total) for g in gs]
        jg = jax.tree.unflatten(jax.tree.structure(jp),
                                [jnp.asarray(g) for g in gs])
        up, js = opt.update(jg, js, jp)
        jp = optax.apply_updates(jp, up)
        tg = [torch.from_numpy(g) for g in gs]
        optim.clip_by_global_norm(tg, tcfg.clip_norm)
        lr = optim.warmup_cosine_decay(st.count, tcfg.lr, tcfg.warmup,
                                       tcfg.steps, tcfg.lr * 0.1)
        optim.adamw_update(ps, tg, st, lr, tcfg.weight_decay)
        if i == 0:
            for a, b in zip(ps, jax.tree.leaves(jp)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(st.count) == 3
    for a, b in zip(ps, jax.tree.leaves(jp)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= (
            1e-3 if mu_dtype == "float32" else 1e-2) * tcfg.lr
    adam = js[1][0]
    for m, jm in zip(st.mu, jax.tree.leaves(adam.mu)):
        assert m.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[mu_dtype]
        _close(m.float().numpy(), np.asarray(jm, np.float32),
               1e-6 if mu_dtype == "float32" else 2 ** -8, "mu")
    for v, jv in zip(st.nu, jax.tree.leaves(adam.nu)):
        _close(v.numpy(), jv, 1e-6, "nu")


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_optax(mu_dtype, monkeypatch):
    """run_chunk (three steps on three fixed batches, each package taking
    its own gradients) against the JAX trainer's step (value_and_grad,
    the optax chain, apply_updates). The first step has lr 0. After it
    Adam moves an element by about lr * sign(g), so where |g| is within
    f32 noise of 0 the two packages may step opposite ways: no element
    may differ by more than 2 lr (the most two such steps can part them),
    and 99.9% of the elements agree within 1e-3 lr (1e-2 lr with mu in
    bf16, where a moment at a bf16 rounding boundary may be stored one
    ulp apart, test_adamw_same_grads_matches_optax); the first loss (the
    same parameters) within 1e-6 relative, the later ones within 1e-5."""
    tcfg = dataclasses.replace(TCFG3, mu_dtype=mu_dtype)
    jc, jp, tc, tp = _carried(10, **CASES["dense"])
    batches = [_toks(20 + i, (tcfg.batch, tcfg.seq_len)) for i in range(3)]
    opt = _optax_chain(tcfg)
    js = opt.init(jp)
    jl = []
    for b in batches:
        loss, g = jax.value_and_grad(jt.next_token_loss)(jp, jc,
                                                         jnp.asarray(b))
        up, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, up)
        jl.append(float(loss))
    it = iter(batches)
    monkeypatch.setattr(pt, "_sample_batch",
                        lambda *a, **k: torch.from_numpy(next(it)))
    st = optim.adamw_init(pt.leaves(tp), mu_dtype)
    losses = pt.run_chunk(tp, st, tc, tcfg, None, 0, None)
    np.testing.assert_allclose(losses[0].numpy(), jl[0], rtol=1e-6)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-5)
    diffs = np.concatenate([
        np.abs(a.numpy() - np.asarray(b)).ravel()
        for a, b in zip(pt.leaves(tp), jax.tree.leaves(jp))])
    assert diffs.max() <= 2 * tcfg.lr
    tight = 1e-3 if mu_dtype == "float32" else 1e-2
    assert np.mean(diffs <= tight * tcfg.lr) >= 0.999
    assert not any(p.requires_grad for p in pt.leaves(tp))


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_export_hf_bytes_match_jax(case, tmp_path):
    """The port's export_hf writes JAX's files byte for byte: shards,
    index and config.json (the MoE dict exported as JAX exports it)."""
    jc, jp, tc, tp = _carried(11, **CASES[case])
    jt.export_hf(jp, jc, str(tmp_path / "jax"))
    export_hf(tp, tc, str(tmp_path / "port"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for n in names:
        assert ((tmp_path / "jax" / n).read_bytes()
                == (tmp_path / "port" / n).read_bytes()), n


def test_params_round_trip_through_bridge():
    """train_params_to_numpy / train_params_from_numpy: the JAX pytree's
    keys and leaves, bit for bit both ways."""
    jc, jp, tc, tp = _carried(12, **CASES["moe"])
    back = train_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


LINE = re.compile(r"^step +\d+  train \d+\.\d{4}  holdout \d+\.\d{4}$")


@pytest.mark.parametrize("steps,chunk,late,want", [
    (7, 3, False, [3, 6, 9]),       # overshoot: whole chunks
    (2, 25, False, [2]),            # chunk clamped to the steps
    (7, 3, True, [3]),              # past the deadline: the first chunk
])
def test_train_step_counts_match_jax(steps, chunk, late, want):
    """train's history steps against JAX's trainer on the same config and
    params: whole chunks past `steps` (JAX's steps=60, scan_chunk=25
    runs 75), scan_chunk clamped to steps and warmup to steps - 1 (a
    warmup of 100 over 2 steps runs), and the deadline rule (a deadline
    already past still runs one chunk); the progress lines' format."""
    tcfg = TrainConfig(batch=2, seq_len=8, steps=steps, warmup=100,
                       scan_chunk=chunk, holdout_frac=0.25)
    corpus = np.arange(200, dtype=np.int32) % V
    deadline = time.time() - 1 if late else None
    jc, jp, tc, tp = _carried(13, **CASES["dense"])
    lines = {"jax": [], "port": []}
    _, jh = jt.train(jc, corpus, tcfg, params=jp,
                     progress=lines["jax"].append, deadline=deadline)
    _, th = train(tc, corpus, tcfg, params=tp,
                  progress=lines["port"].append, deadline=deadline,
                  device="cpu")
    assert [h[0] for h in th] == [h[0] for h in jh] == want
    assert all(LINE.match(s) for s in lines["jax"] + lines["port"]), lines
    assert len(lines["port"]) == len(th)
    assert all(math.isfinite(x) for h in th for x in h[1:])


def test_sample_batch_window_and_bos():
    """Crops start in [lo, hi - seq_len - 1), are contiguous corpus
    slices, int32, with bos_id written over column 0."""
    corpus = torch.arange(1000, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    toks = pt._sample_batch(corpus, g, 64, 10, 100, 300, bos_id=7)
    assert toks.dtype == torch.int32 and toks.shape == (64, 10)
    assert bool((toks[:, 0] == 7).all())
    starts = toks[:, 1] - 1
    assert int(starts.min()) >= 100 and int(starts.max()) < 300 - 10 - 1
    assert bool((toks[:, 1:] == starts[:, None]
                 + torch.arange(1, 10)).all())


def test_entry_points_need_a_device_or_the_card():
    """Without a card and without device="cpu" the entry points raise
    (resolve_device), as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(_cfg(), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(_cfg(), np.zeros(100, np.int32), TrainConfig(steps=1))
