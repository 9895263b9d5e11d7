"""The port's MoE path (top-2 routed experts, instance = l * E + e) held
against the JAX package on tiny_test_model(n_experts=4,
n_experts_per_tok=2): the same weights (JAX init_random_weights carried
across by the bridge) through the FFN, decode, prefill and batched
serving, and the routed instance given as a 0-d int32 tensor.

Routes pair up as: port "reference" with JAX "jnp", port "kernel" (K1's
and K4's plain versions on the CPU) with JAX "pallas" (interpret mode),
and "dense" with "dense". Layouts: row-prefix (bucket_size 1, chunk_rows
8) bf16 and int8, fused and not, and rank-prefix (bucket_size 4,
chunk_rows 8). The routing is compared first: JAX's jnp.dot and the
port's f32 product of the bf16 gate may round a logit differently in the
last bit, so each test also prints the smallest margin between an input's
second and third logits.
"""

import asyncio
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

import effort_tpu.kernels.fused_stream as jax_fs
from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu.serving.batcher import BatchEngine as JaxBatchEngine
from effort_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from effort_tpu_torch.config import tiny_test_model
from effort_tpu_torch.kernels import LAUNCHES, fused_stream
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.ops.bucketmul import bucket_matvec
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from effort_tpu_torch.serving.server import make_batch_server, make_server
from test_torch_bridge import cos, jax_weights_to_numpy, np_of, torch_np

torch.set_num_threads(2)

MOE = dict(n_experts=4, n_experts_per_tok=2, max_seq_len=64)
PROMPT = [3, 9, 27]
TOKENS = [1, 5, 9, 33, 7, 100]
PAD = 8
# (dtype, fuse, bucket_size): row-prefix layouts, then the rank-prefix one
LAYOUTS = [("bf16", True, 1), ("int8", True, 1), ("int8", False, 1),
           ("int8", True, 4)]
ROW = [c for c in LAYOUTS if c[2] == 1]
IDS = ["-".join(map(str, c)) for c in LAYOUTS]


def _cfg(**kw):
    return tiny_test_model(**MOE, **kw)


def _jcfg(**kw):
    return jax_tiny(**MOE, **kw)


@pytest.fixture(scope="module")
def models():
    """(dtype, fuse, bucket_size) -> (JAX weights, port weights), built
    once: calibrated random weights, int8 LM head, dense copies on the
    row-prefix layouts."""
    cache = {}

    def get(dtype, fuse, B):
        if (dtype, fuse, B) not in cache:
            jw = jax_tf.quantize_head(jax_tf.init_random_weights(
                _jcfg(), JaxBucketConfig(bucket_size=B, chunk_rows=8,
                                         dtype=dtype),
                seed=1, calibrate=True, fuse=fuse, keep_dense=B == 1))
            cache[dtype, fuse, B] = (
                jw, model_weights_from_numpy(jax_weights_to_numpy(jw)))
        return cache[dtype, fuse, B]
    return get


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode (the fused kernels by their
    module flag, the split stream through a patched pallas_call)."""
    monkeypatch.setattr(jax_fs, "_INTERPRET", True)
    call = jax_pallas.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return call(*args, **kw)
    monkeypatch.setattr(jax_pallas, "pallas_call", interpreted)


@pytest.fixture
def full_tau(monkeypatch):
    """tau = 1: every selected row is streamed, so K2's stream to the
    longest row's length adds only rows whose u is 0."""
    monkeypatch.setattr(fused_stream, "_TAU", 1.0)


def _inputs(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)) * 2.0).astype(np.float32)


def _jax_route(jw, cfg, l, x):
    """JAX's top-2 (lax.top_k of its f32 gate logits) and the margin of
    its second logit over its third."""
    logits = np.asarray(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                                jw.layers.ffn_gate[l],
                                preferred_element_type=jnp.float32))
    order = np.argsort(-logits, kind="stable")
    k = cfg.n_experts_per_tok
    return order[:k], logits[order[k - 1]] - logits[order[k]]


@pytest.mark.parametrize("dtype,fuse,B", LAYOUTS, ids=IDS)
def test_ffn_matches_jax(models, interpret, dtype, fuse, B):
    """The MoE branch of _ffn at each layer for 2 inputs at effort 0.5:
    the routing equals JAX's, then port "reference" against JAX "jnp" and
    port "kernel" against JAX "pallas" at cos >= 0.9999."""
    jw, tw = models(dtype, fuse, B)
    cfg, jcfg = _cfg(), _jcfg()
    pe = port_tf.proj_efforts(0.5, cfg)
    margins = []
    for l in range(cfg.n_layers):
        for x in _inputs(2, cfg.dim, seed=l):
            want, margin = _jax_route(jw, jcfg, l, x)
            margins.append(float(margin))
            gates, idx = port_tf.route(tw.layers, l, torch.from_numpy(x),
                                       cfg)
            assert idx.tolist() == want.tolist(), (l, margin)
            assert abs(float(gates.sum()) - 1.0) < 1e-6
            for jimpl, timpl in (("jnp", "reference"), ("pallas", "kernel")):
                yj = np.asarray(jax_tf._ffn(jw.layers, l, jnp.asarray(x),
                                            0.5, jcfg, jimpl))
                yt = port_tf._ffn(tw.layers, l, torch.from_numpy(x), pe,
                                  cfg, timpl).numpy()
                assert cos(yj, yt) >= 0.9999, (l, timpl, cos(yj, yt))
    print("smallest top-2 margin", min(margins))


def _port_logits(tw, impl, effort):
    cfg = _cfg()
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    return np.stack([port_tf.forward_token(tw, cfg, t, p, kc, vc,
                                           effort=effort, impl=impl).numpy()
                     for p, t in enumerate(TOKENS)])


def _jax_engine(jw, impl, B):
    # JAX's rank-prefix kernel sizes its prologue from a static effort
    return JaxEngine(jw, _jcfg(), impl=impl, pad_to=PAD,
                     dynamic_effort=B == 1 or impl != "pallas")


@pytest.mark.parametrize("dtype,fuse,B", LAYOUTS, ids=IDS)
def test_forward_token_logits_match_jax(models, interpret, dtype, fuse, B):
    """Teacher-forced logits over 6 positions at effort 0.5: "reference"
    against "jnp" at cos >= 0.9999, "kernel" against "pallas" at 0.999 (as
    the dense model's test); no kernel launch counted on the CPU."""
    jw, tw = models(dtype, fuse, B)
    launches = dict(LAUNCHES)
    for jimpl, timpl, tol in (("jnp", "reference", 0.9999),
                              ("pallas", "kernel", 0.999)):
        lj = _jax_engine(jw, jimpl, B).position_logits(TOKENS, effort=0.5)
        lt = _port_logits(tw, timpl, 0.5)
        for p in range(len(TOKENS)):
            assert cos(lj[p], lt[p]) >= tol, (timpl, p, cos(lj[p], lt[p]))
    assert LAUNCHES == launches


@pytest.mark.parametrize("dtype,fuse,B", LAYOUTS, ids=IDS)
def test_generate_matches_jax(models, interpret, dtype, fuse, B):
    """Engine.generate's tokens and per-step predictions equal JAX's at
    effort 0.6 on the kernel and reference routes, and at 1.0 through the
    dense copies (row-prefix) or the reference (rank-prefix)."""
    jw, tw = models(dtype, fuse, B)
    cfg = _cfg()
    runs = [("pallas", "kernel", 0.6), ("jnp", "reference", 0.6)]
    runs.append(("dense", "auto", 1.0) if B == 1 else
                ("jnp", "reference", 1.0))
    for jimpl, timpl, effort in runs:
        rj = _jax_engine(jw, jimpl, B).generate(PROMPT, n_new=5,
                                                effort=effort)
        rt = Engine(tw, cfg, impl=timpl, pad_to=PAD, device="cpu").generate(
            PROMPT, n_new=5, effort=effort)
        assert rt.token_ids == rj.token_ids, (timpl, effort)
        assert rt.predictions == rj.predictions, (timpl, effort)


def _left_padded(prompt):
    off = PAD - len(prompt)
    return [0] * off + list(prompt), off


@pytest.mark.parametrize("dtype,fuse,B", [LAYOUTS[1], LAYOUTS[3]],
                         ids=[IDS[1], IDS[3]])
def test_forward_seq_reference_matches_jax(models, dtype, fuse, B):
    """Prefill of a left-padded prompt: the port's "reference" (each token
    through the per-token FFN) against JAX's "jnp" (its vmap of it): the
    logits at every real position (rtol and atol 2e-3: f32 sums in
    another order) and the K rows written (bf16 rows: rtol 2e-2, atol
    1e-2, as the dense model's prefill test)."""
    jw, tw = models(dtype, fuse, B)
    ids, off = _left_padded(PROMPT)
    kj, vj = jax_tf.make_kv_cache(_jcfg())
    lj, kj, _ = jax_tf.forward_seq(jw, _jcfg(), jnp.asarray(ids), kj, vj,
                                   rope_offset=off, mask_from=off,
                                   effort=0.6, impl="jnp", attn_impl="xla")
    kt, vt = port_tf.make_kv_cache(_cfg(), "cpu")
    lt = port_tf.forward_seq(tw, _cfg(), torch.tensor(ids), kt, vt,
                             rope_offset=off, mask_from=off, effort=0.6,
                             impl="reference")
    np.testing.assert_allclose(lt.numpy()[off:], np.asarray(lj)[off:],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(kt.float().numpy(),
                               np.asarray(kj.astype(jnp.float32)),
                               rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("dtype,fuse,B", ROW, ids=IDS[:3])
def test_prefill_kernel_route_matches_token_loop(models, full_tau, dtype,
                                                 fuse, B):
    """At tau = 1, Engine(prefill=True) on the kernel route (the routing
    read once a layer, K2's plain version once per expert over its rows)
    gives the token loop's tokens at effort 0.6 (as the JAX package's
    tests/test_prefill.py holds its prefill to its scan), and its
    prompt logits keep cos >= 0.999 to the token loop's; the routing
    read counts once a layer."""
    _, tw = models(dtype, fuse, B)
    cfg = _cfg()
    loop = Engine(tw, cfg, impl="kernel", pad_to=4, device="cpu")
    pre = Engine(tw, cfg, impl="kernel", pad_to=4, prefill=True,
                 prefill_impl="kernel", device="cpu")
    port_tf.HOST_READS["moe_routing"] = 0
    assert pre.generate(PROMPT, n_new=4, effort=0.6).token_ids == \
        loop.generate(PROMPT, n_new=4, effort=0.6).token_ids
    assert port_tf.HOST_READS["moe_routing"] == cfg.n_layers
    lp = pre.position_logits(TOKENS, effort=0.6)
    ll = loop.position_logits(TOKENS, effort=0.6)
    assert min(cos(a, b) for a, b in zip(lp, ll)) >= 0.999


def test_grouped_ffn_rows_at_own_efforts(models, full_tau):
    """The grouped MoE FFN (K2's plain version once per expert) takes each
    row at its own effort: at tau = 1 it gives every row of 6 at efforts
    0.3-1.0 the per-row FFN on the plain K1 route at cos >= 0.9999."""
    _, tw = models("int8", True, 1)
    cfg = _cfg()
    X = torch.from_numpy(_inputs(6, cfg.dim, seed=9))
    pe = port_tf.proj_efforts(torch.tensor([0.3, 0.6, 1.0, 0.6, 0.3, 0.9]),
                              cfg)
    y = port_tf._moe_grouped(tw.layers, 1, X, pe, cfg, "plain")
    yr = port_tf._moe_rows(tw.layers, 1, X, pe, cfg, "plain")
    for a, b in zip(y.numpy(), yr.numpy()):
        assert cos(a, b) >= 0.9999


@pytest.mark.parametrize("dtype,fuse,B", [LAYOUTS[1], LAYOUTS[3]],
                         ids=[IDS[1], IDS[3]])
def test_batch_engine_matches_jax(models, dtype, fuse, B):
    """Three requests, mixed efforts, through four slots: the port's
    BatchEngine(impl="reference") gives JAX's BatchEngine(impl="jnp",
    prefill_impl="jnp") tokens."""
    jw, tw = models(dtype, fuse, B)
    prompts, efforts = [[1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 3]], \
        [1.0, 0.6, 0.4]
    jcb = JaxBatcher(JaxBatchEngine(jw, _jcfg(), batch_size=4, pad_to=PAD,
                                    impl="jnp", prefill_impl="jnp"))
    tcb = ContinuousBatcher(BatchEngine(tw, _cfg(), batch_size=4,
                                        pad_to=PAD, impl="reference",
                                        prefill_impl="reference",
                                        device="cpu"))
    got = {}
    for cb, out in ((jcb, "jax"), (tcb, "port")):
        for i, (p, e) in enumerate(zip(prompts, efforts)):
            cb.submit(p, 5, e, lambda toks, i=i, out=out:
                      got.__setitem__((out, i), toks))
        cb.run_until_drained()
    for i in range(len(prompts)):
        assert got["port", i] == got["jax", i], i


def test_batch_step_matches_single_stream(models, full_tau):
    """One batched MoE decode step on the kernel route (K1 a slot and
    expert) gives each slot the logits of forward_token at the slot's
    effort on copies of the same cache, bit for bit."""
    _, tw = models("int8", True, 1)
    cfg = _cfg()
    be = BatchEngine(tw, cfg, batch_size=3, pad_to=PAD, impl="kernel",
                     device="cpu")
    for b, (p, e) in enumerate(zip([[1, 5, 9], [4, 8], [7, 7, 3, 2]],
                                   [0.3, 0.6, 1.0])):
        be.admit(b, b, p, 5, e)
    be.step()
    kc, vc = be.k_cache.clone(), be.v_cache.clone()
    lb = port_tf.forward_token_batch(be.w, cfg, be.tokens, be.pos, kc, vc,
                                     be.efforts, offs=be.offs, impl="kernel")
    for b in range(3):
        kv = (be.k_cache[:, b].clone(), be.v_cache[:, b].clone())
        off = int(be.offs[b])
        ls = port_tf.forward_token(be.w, cfg, be.tokens[b], int(be.pos[b]),
                                   *kv, effort=be.efforts[b], impl="kernel",
                                   rope_offset=off, mask_from=off)
        assert cos(lb[b].numpy(), ls.numpy()) >= 0.9999, b
        assert int(lb[b].argmax()) == int(ls.argmax()), b


@pytest.mark.parametrize("dtype,fuse,B", LAYOUTS, ids=IDS)
def test_tensor_instance_bit_for_bit(models, dtype, fuse, B):
    """Every instance of the w13 and w2 containers, given as a 0-d int32
    tensor, gives the int instance's result bit for bit: in K1's and K4's
    plain versions (y, C and u) and in bucket_matvec on every route the
    layout takes."""
    _, tw = models(dtype, fuse, B)
    lw = tw.layers
    routes = ["reference", "kernel", "plain"] + (
        ["dense"] if B == 1 else ["stream", "gather"])
    for bm in (lw.any_w1, lw.w2):
        v = torch.from_numpy(_inputs(1, bm.in_dim, seed=3)[0])
        for e in range(bm.n_experts):
            t = torch.tensor(e, dtype=torch.int32)
            if B == 1:
                for tau in (0.97, 1.0):
                    a = fused_stream.mxu_select_ref(bm, v, 0.4, e, tau)
                    b = fused_stream.mxu_select_ref(bm, v, 0.4, t, tau)
                    for x, y in zip(a, b):
                        assert torch.equal(x, y), (e, tau)
                    assert torch.equal(
                        fused_stream.mxu_matvec_ref(bm, v, 0.4, e, tau),
                        fused_stream.mxu_matvec_ref(bm, v, 0.4, t, tau))
            else:
                ya, Ca, sa = fused_stream.fused_matvec_ref(
                    bm, v, 0.4, e, return_selection=True)
                yb, Cb, sb = fused_stream.fused_matvec_ref(
                    bm, v, 0.4, t, return_selection=True)
                assert torch.equal(ya, yb) and torch.equal(Ca, Cb), e
                for x, y in zip(sa, sb):
                    assert torch.equal(x, y), e
            for impl in routes:
                assert torch.equal(bucket_matvec(bm, v, 0.4, e, impl),
                                   bucket_matvec(bm, v, 0.4, t, impl)), \
                    (e, impl)


def test_tile_layers_matches_jax(models):
    """tile_layers of a 1-layer MoE model equals JAX's field by field, and
    the tiled model's teacher-forced logits on the reference route equal
    JAX's "jnp" ones within rtol and atol 2e-3 (f32 sums in another
    order)."""
    jcfg1, cfg1 = _jcfg(n_layers=1), _cfg(n_layers=1)
    jw1 = jax_tf.init_random_weights(
        jcfg1, JaxBucketConfig(bucket_size=1, chunk_rows=8, dtype="int8"),
        seed=2, calibrate=True, fuse=True)
    tw1 = model_weights_from_numpy(jax_weights_to_numpy(jw1))
    jw, tw = jax_tf.tile_layers(jw1, jcfg1, 3), port_tf.tile_layers(tw1,
                                                                    cfg1, 3)
    jl, tl = jw.layers, tw.layers
    for f in ("attn_norm", "ffn_norm", "ffn_gate"):
        np.testing.assert_array_equal(torch_np(getattr(tl, f)),
                                      np_of(getattr(jl, f)), err_msg=f)
    for f in port_tf.PROJ_FIELDS:
        a, b = getattr(jl, f), getattr(tl, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        assert b.n_experts == a.n_experts == 3 * (
            1 if f in ("wqkv", "wo") else cfg1.n_experts), f
        for g in ("vals", "stats", "probes", "scales"):
            np.testing.assert_array_equal(torch_np(getattr(b, g)),
                                          np_of(getattr(a, g)),
                                          err_msg=f"{f}.{g}")
    cfg3 = _cfg(n_layers=3)
    lj = JaxEngine(jw, _jcfg(n_layers=3), impl="jnp", pad_to=PAD,
                   dynamic_effort=True).position_logits(TOKENS, effort=0.6)
    kc, vc = port_tf.make_kv_cache(cfg3, "cpu")
    lt = np.stack([port_tf.forward_token(tw, cfg3, t, p, kc, vc, effort=0.6,
                                         impl="reference").numpy()
                   for p, t in enumerate(TOKENS)])
    np.testing.assert_allclose(lt, lj, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError):
        port_tf.tile_layers(tw, cfg3, 2)


def test_moe_runs_every_route(models):
    """forward_token on every route a dense model takes, on both layouts,
    and forward_seq and forward_token_batch on theirs: finite logits, no
    NotImplementedError for n_experts > 1."""
    cfg = _cfg()
    for (dtype, fuse, B), routes in (
            (("int8", False, 1), ("auto", "kernel", "plain", "reference",
                                  "dense")),
            (("int8", True, 4), ("auto", "kernel", "plain", "reference",
                                 "stream", "gather"))):
        _, tw = models(dtype, fuse, B)
        for impl in routes:
            kc, vc = port_tf.make_kv_cache(cfg, "cpu")
            effort = 1.0 if impl == "dense" else 0.5
            lg = port_tf.forward_token(tw, cfg, 5, 0, kc, vc, effort=effort,
                                       impl=impl)
            assert bool(torch.isfinite(lg).all()), (B, impl)
        seq_routes = ("auto", "reference", "kernel", "plain", "dense") \
            if B == 1 else ("auto", "reference")
        for impl in seq_routes:
            kc, vc = port_tf.make_kv_cache(cfg, "cpu")
            lg = port_tf.forward_seq(tw, cfg, torch.tensor([1, 5, 9, 2]), kc,
                                     vc, effort=torch.tensor(0.5), impl=impl)
            assert bool(torch.isfinite(lg).all()), (B, impl)
        kc, vc = port_tf.make_batch_kv_cache(cfg, 2, "cpu")
        lg = port_tf.forward_token_batch(
            tw, cfg, torch.tensor([1, 5], dtype=torch.int32),
            torch.tensor([0, 0], dtype=torch.int32), kc, vc,
            torch.tensor([0.5, 1.0]))
        assert lg.shape == (2, cfg.vocab_size)
        assert bool(torch.isfinite(lg).all()), B


def _fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.status, json.loads(r.read().decode())


def _serve(srv, paths):
    async def run():
        await srv.start()
        try:
            loop = asyncio.get_running_loop()
            return [await loop.run_in_executor(None, _fetch, srv.port, p)
                    for p in paths]
        finally:
            await srv.stop()
    return asyncio.run(run())


def test_servers_answer_on_moe(models):
    """make_server (single flight) and make_batch_server answer /q with
    the requested token count on the MoE model."""
    _, tw = models("int8", True, 1)
    cfg = _cfg()
    paths = ["/q?query=hello&effort=50&numtokens=4",
             "/q?query=moe&effort=100&numtokens=4"]
    for srv in (make_server(Engine(tw, cfg, pad_to=PAD, device="cpu"),
                            port=0),
                make_batch_server(tw, cfg, batch_size=2, pad_to=PAD, port=0,
                                  device="cpu")):
        for st, body in _serve(srv, paths):
            assert st == 200
            assert len(json.loads(body["reply"])) == 4


def test_assemble_weights_moe_matches_jax():
    """The port's relayout and bucketization of the same raw MoE weights
    equal JAX's: the gate with its rows in the baked order (bit for bit,
    bf16) and every instance of the fused expert projections."""
    from effort_tpu_torch.config import BucketConfig
    jcfg, cfg = _jcfg(n_layers=1), _cfg(n_layers=1)
    rng = np.random.default_rng(4)
    rms_m = np.exp(rng.standard_normal(jcfg.dim)).astype(np.float32)
    rms_f = np.exp(rng.standard_normal(jcfg.hidden_dim)).astype(np.float32)
    raw = jax_tf.synth_raw_weights(jcfg, rms_m=jnp.asarray(rms_m),
                                   rms_f=jnp.asarray(rms_f))
    jw = jax_tf.assemble_weights(
        raw, jcfg, JaxBucketConfig(bucket_size=1, chunk_rows=8,
                                   dtype="int8"),
        rms_m=jnp.asarray(rms_m), rms_f=jnp.asarray(rms_f), fuse=True)
    tw = port_tf.assemble_weights(
        {k: (None if a is None else torch.from_numpy(np.array(a)))
         for k, a in raw.items()}, cfg,
        BucketConfig(bucket_size=1, chunk_rows=8, dtype="int8"),
        rms_m=torch.from_numpy(rms_m), rms_f=torch.from_numpy(rms_f),
        fuse=True)
    np.testing.assert_array_equal(torch_np(tw.layers.ffn_gate),
                                  np_of(jw.layers.ffn_gate))
    for f in ("w13", "w2"):
        a, b = getattr(jw.layers, f), getattr(tw.layers, f)
        assert b.n_experts == a.n_experts == cfg.n_experts
        np.testing.assert_array_equal(torch_np(b.vals), np_of(a.vals),
                                      err_msg=f)
        np.testing.assert_allclose(b.stats.numpy(), np_of(a.stats),
                                   rtol=1e-6, atol=0)
