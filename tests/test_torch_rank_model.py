"""The port's decode on the rank-prefix layout (bucket_size = 4), held
against the JAX package on tiny_test_model: the same weights (JAX
init_random_weights carried across by the bridge), teacher-forced logits
and greedy generation through the kernel and the reference routes; prefill
and batched serving on a rank-prefix model (their projections take the
per-row reference semantics, as JAX's take "jnp"); and server.main()'s
arguments.

Routes pair up as: port "kernel" (K4's plain version on the CPU) with JAX
"pallas" (in interpret mode: JAX's fused kernel where its 128-lane rule
holds, its select_stream + stream_matvec elsewhere), and port "reference"
with JAX "jnp". Both engines pad prompts to 8 positions.
"""

import asyncio
import json
import urllib.request

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
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.ops.bucketmul import bucket_matmul
from effort_tpu_torch.serving import server as port_server
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from test_torch_bridge import cos, jax_weights_to_numpy

torch.set_num_threads(2)

PROMPT = [1, 5, 9]
TOKENS = [1, 5, 9, 33, 7, 100]
PAD = 8
PROMPTS = [[1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 7, 3]]


def _cfg():
    return tiny_test_model(max_seq_len=64)


@pytest.fixture(scope="module")
def model():
    """The tiny model with BucketConfig(bucket_size=4, chunk_rows=8) (the
    JAX package's own default layout, and server.main()'s synthetic
    model), fused projections, int8 LM head; JAX's and the port's copy."""
    jw = jax_tf.quantize_head(jax_tf.init_random_weights(
        jax_tiny(max_seq_len=64), JaxBucketConfig(bucket_size=4,
                                                  chunk_rows=8),
        calibrate=True, fuse=True))
    return jw, model_weights_from_numpy(jax_weights_to_numpy(jw))


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode (the fused kernel by its
    module flag, the split stream through a patched pallas_call)."""
    monkeypatch.setattr(jax_fs, "_INTERPRET", True)
    call = jax_pallas.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return call(*args, **kw)
    monkeypatch.setattr(jax_pallas, "pallas_call", interpreted)


def test_position_logits_match_jax(model, interpret):
    """Teacher-forced logits over 6 positions at effort 0.5: port "kernel"
    against JAX "pallas" at cos >= 0.999 (the two search the cutoff with
    thresholds that differ in the last bit on the projections where JAX
    takes its split stream, which can move a row), and "reference" against
    "jnp" at cos >= 0.9999."""
    jw, tw = model
    for jimpl, timpl, tol in (("pallas", "kernel", 0.999),
                              ("jnp", "reference", 0.9999)):
        lj = JaxEngine(jw, jax_tiny(max_seq_len=64), impl=jimpl,
                       pad_to=PAD).position_logits(TOKENS, effort=0.5)
        lt = Engine(tw, _cfg(), impl=timpl, pad_to=PAD,
                    device="cpu").position_logits(TOKENS, effort=0.5)
        for p in range(len(TOKENS)):
            assert cos(lj[p], lt[p]) >= tol, (jimpl, p, cos(lj[p], lt[p]))


@pytest.mark.parametrize("effort", [0.25, 0.5])
def test_generate_matches_jax(model, interpret, effort):
    """Token ids and every per-step prediction equal JAX's: "kernel"
    against "pallas" (static effort) and "reference" against "jnp". The
    CPU run counts no launch."""
    jw, tw = model
    before = dict(LAUNCHES)
    for jimpl, timpl in (("pallas", "kernel"), ("jnp", "reference")):
        rj = JaxEngine(jw, jax_tiny(max_seq_len=64), impl=jimpl,
                       pad_to=PAD).generate(PROMPT, n_new=6, effort=effort)
        rt = Engine(tw, _cfg(), impl=timpl, pad_to=PAD,
                    device="cpu").generate(PROMPT, n_new=6, effort=effort)
        assert rt.token_ids == rj.token_ids, (timpl, effort)
        assert rt.predictions == rj.predictions, (timpl, effort)
    assert LAUNCHES == before


def test_stream_and_gather_engines(model):
    """Engine(impl="stream") decodes the kernel route's tokens (K5 on the
    selection K4 would make differs only in the threshold table); the
    gather engine decodes with the reference's exact coverage (every
    selected block fits at the route's capacity here), token for token."""
    _, tw = model
    cfg = _cfg()
    out = {impl: Engine(tw, cfg, impl=impl, pad_to=PAD, device="cpu")
           .generate(PROMPT, n_new=6, effort=0.5)
           for impl in ("stream", "kernel", "gather", "reference")}
    assert out["stream"].token_ids == out["kernel"].token_ids
    assert out["gather"].token_ids == out["reference"].token_ids
    assert out["gather"].predictions == out["reference"].predictions


def test_prefill_engine_matches_jax(model):
    """Repair of the rank-prefix prefill: Engine(prefill=True) on a B = 4
    model runs its prompt through forward_seq, whose bucket_matmul "auto"
    takes the reference semantics (K2 is row-prefix only), then decodes on
    the reference route: tokens and predictions equal JAX's
    Engine(prefill=True, impl="jnp")."""
    jw, tw = model
    for effort in (0.5, 1.0):
        rj = JaxEngine(jw, jax_tiny(max_seq_len=64), impl="jnp", pad_to=PAD,
                       prefill=True).generate(PROMPT, n_new=6, effort=effort)
        rt = Engine(tw, _cfg(), impl="reference", pad_to=PAD, prefill=True,
                    device="cpu").generate(PROMPT, n_new=6, effort=effort)
        assert rt.token_ids == rj.token_ids, effort
        assert rt.predictions == rj.predictions, effort
    # at its defaults the prefill engine runs too (decode steps: K4's plain
    # version)
    r = Engine(tw, _cfg(), pad_to=PAD, prefill=True, device="cpu").generate(
        PROMPT, n_new=4, effort=0.5)
    assert len(r.token_ids) == 4


def test_batch_engine_matches_jax(model):
    """Repair of rank-prefix batching: BatchEngine at its defaults (every
    projection a bucket_matmul whose "auto" takes the reference on B = 4)
    serves three requests of mixed efforts through four slots with JAX's
    BatchEngine tokens (its default "jnp")."""
    jw, tw = model
    efforts = [1.0, 0.5, 0.25]
    jcb = JaxBatcher(JaxBatchEngine(jw, jax_tiny(max_seq_len=64),
                                    batch_size=4, pad_to=PAD))
    ref, got = {}, {}
    for i, (p, e) in enumerate(zip(PROMPTS, efforts)):
        jcb.submit(p, 6, e, lambda toks, i=i: ref.__setitem__(i, toks))
    jcb.run_until_drained()
    cb = ContinuousBatcher(BatchEngine(tw, _cfg(), batch_size=4, pad_to=PAD,
                                       device="cpu"))
    for i, (p, e) in enumerate(zip(PROMPTS, efforts)):
        cb.submit(p, 6, e, lambda toks, i=i: got.__setitem__(i, toks))
    cb.run_until_drained()
    assert got == ref


def test_batched_kernel_routes_refuse_rank_prefix(model):
    """bucket_matmul's "kernel" and "plain" are K2's routes, row-prefix
    only: on a rank-prefix container they raise; "auto" is the
    reference."""
    _, tw = model
    V = torch.randn((3, 256))
    bm = tw.layers.wo
    for impl in ("kernel", "plain"):
        with pytest.raises(NotImplementedError, match="row-prefix"):
            bucket_matmul(bm, V, 0.5, 0, impl=impl)
    torch.testing.assert_close(bucket_matmul(bm, V, 0.5, 0),
                               bucket_matmul(bm, V, 0.5, 0,
                                             impl="reference"),
                               rtol=0, atol=0)


def test_server_main_arguments():
    """server.main()'s arguments: --synthetic, --port and --batch build the
    tiny B = 4 model's server (on the named device; the card by default),
    single-flight or batched, which answers /q; --kv-dtype int8 builds
    the int8 KV cache (the batch engine's, or the single-flight Engine's
    quant_kv); --spec-k and --draft-effort give speculative decode (single
    flight and batched; not with the int8 cache); --ckpt and --tokenizer
    open the path they name (a missing one raises FileNotFoundError;
    tests/test_torch_convert.py serves a converted checkpoint)."""
    args = port_server.parse_args([])
    assert (args.port, args.batch, args.device) == (8089, 0, None)
    srv = port_server.build_server(port_server.parse_args(
        ["--synthetic", "--port", "0", "--device", "cpu"]))
    assert srv.batcher is None and srv.port == 0
    assert srv.engine.w.layers.wo.bucket_size == 4
    bsrv = port_server.build_server(port_server.parse_args(
        ["--batch", "2", "--port", "0", "--device", "cpu"]))
    assert bsrv.batcher.eng.B == 2
    q8 = port_server.build_server(port_server.parse_args(
        ["--kv-dtype", "int8", "--port", "0", "--device", "cpu"]))
    assert q8.engine.kv_mode == "int8"
    bq8 = port_server.build_server(port_server.parse_args(
        ["--batch", "2", "--kv-dtype", "int8", "--port", "0", "--device",
         "cpu"]))
    assert bq8.batcher.eng.kv_quant
    for argv in (["--ckpt", "no-such-dir"],
                 ["--tokenizer", "no-such-tokenizer.json"]):
        with pytest.raises(FileNotFoundError, match="no-such"):
            port_server.build_server(port_server.parse_args(
                argv + ["--device", "cpu"]))
    sp = port_server.build_server(port_server.parse_args(
        ["--spec-k", "2", "--draft-effort", "0.5", "--port", "0",
         "--device", "cpu"]))
    assert (sp.spec_k, sp.spec_draft_effort) == (2, 0.5)
    bsp = port_server.build_server(port_server.parse_args(
        ["--batch", "2", "--spec-k", "2", "--port", "0", "--device",
         "cpu"]))
    assert bsp.batcher.eng.spec_k == 2
    with pytest.raises(ValueError, match="bf16"):
        port_server.build_server(port_server.parse_args(
            ["--spec-k", "2", "--kv-dtype", "int8", "--device", "cpu"]))

    async def ask(s, effort=50):
        await s.start()
        try:
            url = (f"http://127.0.0.1:{s.port}/q?query=hi&effort={effort}"
                   f"&numtokens=3")
            body = await asyncio.get_running_loop().run_in_executor(
                None, lambda: urllib.request.urlopen(url, timeout=120).read())
            return json.loads(body)
        finally:
            await s.stop()
    for s in (srv, bsrv, q8, bq8, bsp):
        reply = asyncio.run(ask(s))["reply"]
        assert len(json.loads(reply)) <= 3 and reply.startswith("[")
    # single-flight --spec-k answers a full-effort /q speculatively
    sp_reply = asyncio.run(ask(sp, effort=100))["reply"]
    assert sp_reply == str(sp.engine.generate(sp._encode_query("hi"),
                                              n_new=3).token_ids)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_server.build_server(port_server.parse_args([]))
