"""The port's decode path held against the JAX package on tiny_test_model:
the same weights (JAX init_random_weights carried across by the bridge),
teacher-forced logits, and greedy generation through every route.

Routes pair up as: port "reference" with JAX "jnp", port "kernel" (the
kernel's plain version on the CPU) with JAX "pallas" (interpret mode), and
"dense" with "dense". Both engines pad prompts to 8 positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import effort_tpu.kernels.fused_stream as jax_fused_stream
from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu_torch.config import BucketConfig
from effort_tpu_torch.config import tiny_test_model
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from test_torch_bridge import cos, jax_weights_to_numpy, np_of, torch_np

torch.set_num_threads(2)

PROMPT = [1, 5, 9]
TOKENS = [1, 5, 9, 33, 7, 100, 200, 3]
PAD = 8
CASES = [(d, f) for d in ("bf16", "int8") for f in (True, False)]


@pytest.fixture(scope="module")
def models():
    """(dtype, fuse) -> (JAX weights, port weights), built once."""
    cache = {}

    def get(dtype, fuse):
        if (dtype, fuse) not in cache:
            jw = jax_tf.quantize_head(jax_tf.init_random_weights(
                jax_tiny(), JaxBucketConfig(bucket_size=1, chunk_rows=128,
                                            dtype=dtype),
                calibrate=True, fuse=fuse, keep_dense=True))
            cache[dtype, fuse] = (
                jw, model_weights_from_numpy(jax_weights_to_numpy(jw)))
        return cache[dtype, fuse]
    return get


@pytest.fixture
def interpret(monkeypatch):
    """Run JAX's Pallas kernels in interpret mode, as its CPU tests do."""
    monkeypatch.setattr(jax_fused_stream, "_INTERPRET", True)


def _port_logits(tw, impl, effort):
    cfg = tiny_test_model()
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    return np.stack([port_tf.forward_token(tw, cfg, t, p, kc, vc,
                                           effort=effort, impl=impl).numpy()
                     for p, t in enumerate(TOKENS)])


@pytest.mark.parametrize("dtype,fuse", CASES)
def test_forward_token_logits_match_jax(models, interpret, dtype, fuse):
    """Teacher-forced logits over 8 positions at effort 0.5."""
    jw, tw = models(dtype, fuse)
    for jimpl, timpl, tol in (("jnp", "reference", 0.9999),
                              ("pallas", "kernel", 0.999)):
        lj = JaxEngine(jw, jax_tiny(), impl=jimpl, dynamic_effort=True,
                       pad_to=PAD).position_logits(TOKENS, effort=0.5)
        lt = _port_logits(tw, timpl, 0.5)
        for p in range(len(TOKENS)):
            assert cos(lj[p], lt[p]) > tol, (jimpl, p, cos(lj[p], lt[p]))


@pytest.mark.parametrize("dtype,fuse", CASES)
def test_generate_matches_jax(models, interpret, dtype, fuse):
    """Token ids and every per-step prediction equal JAX's, at effort 0.5
    and 1.0 through the kernel and the reference routes, and at 1.0
    through the dense copies."""
    jw, tw = models(dtype, fuse)
    cfg, jcfg = tiny_test_model(), jax_tiny()
    for jimpl, timpl in (("pallas", "kernel"), ("jnp", "reference")):
        je = JaxEngine(jw, jcfg, impl=jimpl, dynamic_effort=True,
                       pad_to=PAD)
        te = Engine(tw, cfg, impl=timpl, pad_to=PAD, device="cpu")
        for effort in (0.5, 1.0):
            rj = je.generate(PROMPT, n_new=6, effort=effort)
            rt = te.generate(PROMPT, n_new=6, effort=effort)
            assert rt.token_ids == rj.token_ids, (timpl, effort)
            assert rt.predictions == rj.predictions, (timpl, effort)
    rj = JaxEngine(jw, jcfg, impl="dense", pad_to=PAD).generate(
        PROMPT, n_new=6, effort=1.0)
    rt = Engine(tw, cfg, pad_to=PAD, device="cpu").generate(
        PROMPT, n_new=6, effort=1.0)
    assert rt.token_ids == rj.token_ids
    assert rt.predictions == rj.predictions


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_assemble_weights_matches_jax(dtype):
    """The port's whole-model relayout and bucketization from the same raw
    weights equal JAX's, container by container."""
    jcfg = jax_tiny(n_layers=1)
    jb = JaxBucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype)
    rng = np.random.default_rng(0)
    rms_m = np.exp(rng.standard_normal(jcfg.dim)).astype(np.float32)
    rms_f = np.exp(rng.standard_normal(jcfg.hidden_dim)).astype(np.float32)
    raw = jax_tf.synth_raw_weights(jcfg, rms_m=jnp.asarray(rms_m),
                                   rms_f=jnp.asarray(rms_f))
    jw = jax_tf.assemble_weights(raw, jcfg, jb, rms_m=jnp.asarray(rms_m),
                                 rms_f=jnp.asarray(rms_f), fuse=True)
    raw_t = {k: (None if a is None else torch.from_numpy(np.array(a)))
             for k, a in raw.items()}
    tw = port_tf.assemble_weights(
        raw_t, tiny_test_model(n_layers=1),
        BucketConfig(bucket_size=1, chunk_rows=128, dtype=dtype),
        rms_m=torch.from_numpy(rms_m), rms_f=torch.from_numpy(rms_f),
        fuse=True)
    for f in ("tok_embeddings", "output", "norm"):
        np.testing.assert_array_equal(torch_np(getattr(tw, f)),
                                      np_of(getattr(jw, f)), err_msg=f)
    for f in ("wqkv", "w13", "wo", "w2"):
        a, b = getattr(jw.layers, f), getattr(tw.layers, f)
        np.testing.assert_array_equal(torch_np(b.vals), np_of(a.vals),
                                      err_msg=f)
        np.testing.assert_allclose(b.stats.numpy(), np_of(a.stats),
                                   rtol=1e-6, atol=0)
        assert (b.chunk_rows, b.n_experts) == (a.chunk_rows, a.n_experts)


def test_port_random_model_decodes():
    """The port's own random weights (torch generators, made on the named
    device) are deterministic per seed and decode; the kernel route counts
    no launch on the CPU; the default device is the card."""
    cfg = tiny_test_model()
    bc = BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8")
    w1 = port_tf.init_random_weights(cfg, bc, seed=3, calibrate=True,
                                     fuse=True, device="cpu")
    w2 = port_tf.init_random_weights(cfg, bc, seed=3, calibrate=True,
                                     fuse=True, device="cpu")
    torch.testing.assert_close(w1.layers.w13.vals, w2.layers.w13.vals,
                               rtol=0, atol=0)
    w = port_tf.quantize_head(w1)
    launches = LAUNCHES["mxu_matvec"]
    r = Engine(w, cfg, eos_id=-1, pad_to=PAD, device="cpu").generate(
        PROMPT, n_new=6, effort=0.25)
    assert len(r.token_ids) == 6 and len(r.predictions) == PAD + 6 - 1
    assert all(0 <= t < cfg.vocab_size for t in r.token_ids)
    assert LAUNCHES["mxu_matvec"] == launches
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(w, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_tf.init_random_weights(cfg, bc)


def test_rope_norm_and_head_match_jax(models):
    """rope_rotate, rms_norm and the int8 head with its exact top-16
    rescore, on the same inputs as JAX's."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    for pos in (0, 7, 100):
        np.testing.assert_allclose(
            port_tf.rope_rotate(torch.from_numpy(x), pos, 64, 1e6).numpy(),
            np.asarray(jax_tf.rope_rotate(jnp.asarray(x), jnp.int32(pos),
                                          64, 1e6)), rtol=1e-5, atol=1e-5)
    g = (1.0 + rng.random(64)).astype(np.float32)
    np.testing.assert_allclose(
        port_tf.rms_norm(torch.from_numpy(x), torch.from_numpy(g),
                         1e-5).numpy(),
        np.asarray(jax_tf.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)),
        rtol=1e-6, atol=1e-6)
    jw, tw = models("int8", True)
    h = rng.standard_normal(256).astype(np.float32)
    lj = np.asarray(jax_tf.head_logits(jw, jnp.asarray(h)))
    lt = port_tf.head_logits(tw, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6)
    assert int(np.argmax(lt)) == int(np.argmax(lj))


def test_truncated_int4_outlier_model_matches_jax():
    """A row-prefix int4 model with outlier tables loaded at half its rows
    (outliers on dropped rows) decodes, and gives JAX's greedy tokens and
    predictions on the reference route; the port's own random weights of
    that configuration decode too."""
    jb = JaxBucketConfig(bucket_size=1, chunk_rows=8, dtype="int4",
                         outlier_frac=0.01)
    jw = jax_tf.init_random_weights(jax_tiny(), jb, calibrate=True,
                                    percent_load=0.5)
    tw = model_weights_from_numpy(jax_weights_to_numpy(jw))
    assert (tw.layers.w2.outlier_idx[..., 0] >= tw.layers.w2.in_dim).any()
    cfg = tiny_test_model()
    rj = JaxEngine(jw, jax_tiny(), impl="jnp", dynamic_effort=True,
                   pad_to=PAD).generate([1, 5, 7], n_new=4, effort=0.5)
    rt = Engine(tw, cfg, impl="reference", pad_to=PAD,
                device="cpu").generate([1, 5, 7], n_new=4, effort=0.5)
    assert rt.token_ids == rj.token_ids
    assert rt.predictions == rj.predictions
    w = port_tf.init_random_weights(
        cfg, BucketConfig(bucket_size=1, chunk_rows=8, dtype="int4",
                          outlier_frac=0.01),
        calibrate=True, percent_load=0.5, device="cpu")
    r = Engine(w, cfg, impl="reference", device="cpu").generate(
        [1, 5, 7], 4, 0.5)
    assert len(r.token_ids) == 4
    assert all(0 <= t < cfg.vocab_size for t in r.token_ids)
