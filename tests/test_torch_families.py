"""The Llama families in the port, held against the JAX package on tiny
configurations of each family's shape (the same weights, carried across by
the bridge), and the HF config.json of each published checkpoint read by
both packages.

  - Llama-2-shaped: multi-head attention (n_kv_heads == n_heads), rope_theta
    1e4, and an FFN 384 wide: at chunk_rows 8 its down projection has 48
    chunks, a count that is not a power of two (Llama-2-7B's w2, 11008
    rows, has 43 chunks of 256 rows at int8). A width of 344 (43 chunks)
    is one JAX's TPU kernel refuses: test_kernel_route_on_shapes_jax_
    kernel_refuses holds the port there.
  - Llama-3-shaped: four query heads a KV head (Llama-3-8B's 32 / 8),
    rope_theta 5e5, and a vocabulary of 1000 (not a power of two; the int8
    head and its top-16 rescore run over it).

Routes pair up as in tests/test_torch_model.py: port "reference" with JAX
"jnp", port "kernel" (the kernels' plain versions on the CPU) with JAX
"pallas" (interpret mode), and "dense" with "dense"; tolerances are that
file's. Both engines pad prompts to 8 positions; the prefill prompt fills
the context up to the new tokens.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import effort_tpu.kernels.fused_stream as jax_fused_stream
from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import llama2_7b as jax_llama2_7b
from effort_tpu.config import llama3_8b as jax_llama3_8b
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.convert import convert as jax_convert
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu.serving.batcher import BatchEngine as JaxBatchEngine
from effort_tpu.serving.batcher import ContinuousBatcher as JaxBatcher
from effort_tpu_torch.config import BucketConfig, llama2_7b, llama3_8b
from effort_tpu_torch.config import tiny_test_model
from effort_tpu_torch.convert import convert as port_convert
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.models import transformer as port_tf
from effort_tpu_torch.models.bridge import model_weights_from_numpy
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.serving.batcher import BatchEngine, ContinuousBatcher
from test_torch_bridge import cos, jax_weights_to_numpy

torch.set_num_threads(2)

PAD = 8
SEQ = 24
N_NEW = 8
PROMPT = [1, 5, 9]
TOKENS = [1, 5, 9, 33, 7, 100, 200, 3]
# the tiny configurations: keyword changes to tiny_test_model
FAMILIES = {
    "llama2": dict(name="llama2-tiny", n_kv_heads=4, hidden_dim=384,
                   rope_theta=1e4, max_seq_len=SEQ),
    "llama3": dict(name="llama3-tiny", n_heads=8, n_kv_heads=2,
                   head_dim=32, vocab_size=1000, rope_theta=5e5,
                   max_seq_len=SEQ),
}
BUCKETS = dict(bucket_size=1, chunk_rows=8, dtype="int8")
# the published config.json of each checkpoint (HF hub:
# meta-llama/Llama-2-7b-hf and meta-llama/Meta-Llama-3-8B), typed in
HF_CONFIGS = {
    "llama2": {
        "architectures": ["LlamaForCausalLM"], "bos_token_id": 1,
        "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
        "initializer_range": 0.02, "intermediate_size": 11008,
        "max_position_embeddings": 4096, "model_type": "llama",
        "num_attention_heads": 32, "num_hidden_layers": 32,
        "num_key_value_heads": 32, "pretraining_tp": 1,
        "rms_norm_eps": 1e-05, "rope_scaling": None,
        "tie_word_embeddings": False, "torch_dtype": "float16",
        "use_cache": True, "vocab_size": 32000},
    "llama3": {
        "architectures": ["LlamaForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 128000,
        "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
        "initializer_range": 0.02, "intermediate_size": 14336,
        "max_position_embeddings": 8192, "model_type": "llama",
        "num_attention_heads": 32, "num_hidden_layers": 32,
        "num_key_value_heads": 8, "pretraining_tp": 1,
        "rms_norm_eps": 1e-05, "rope_scaling": None,
        "rope_theta": 500000.0, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16", "use_cache": True,
        "vocab_size": 128256},
}
PRESETS = {"llama2": (llama2_7b, jax_llama2_7b),
           "llama3": (llama3_8b, jax_llama3_8b)}


def _cfgs(family):
    return (tiny_test_model(**FAMILIES[family]),
            jax_tiny(**FAMILIES[family]))


@pytest.fixture(scope="module")
def models():
    """family -> (JAX weights, port weights): calibrated, fused, int8
    row-prefix with dense copies and the int8 head, built once."""
    cache = {}

    def get(family):
        if family not in cache:
            jw = jax_tf.quantize_head(jax_tf.init_random_weights(
                _cfgs(family)[1], JaxBucketConfig(**BUCKETS),
                calibrate=True, fuse=True, keep_dense=True))
            cache[family] = (
                jw, model_weights_from_numpy(jax_weights_to_numpy(jw)))
        return cache[family]
    return get


@pytest.fixture
def interpret(monkeypatch):
    """Run JAX's Pallas kernels in interpret mode, as its CPU tests do."""
    monkeypatch.setattr(jax_fused_stream, "_INTERPRET", True)


@pytest.fixture
def full_tau(monkeypatch):
    """The coverage target tau = 1 in both packages: each slot streams
    through its last selected chunk. Below 1 the streamed length is the
    first chunk prefix whose mass reaches tau of the total, a comparison
    the port makes on masses summed in f64 and JAX's kernel on f32 sums in
    its own order; with 32 to 48 chunks a prompt of 56 rows puts some
    slot on that boundary, and one chunk more or less moves its logits
    by more than the kernel route's tolerance."""
    monkeypatch.setattr(jax_fused_stream, "_TAU", 1.0)
    monkeypatch.setattr(port_fs, "_TAU", 1.0)


def _prompt(vocab: int, n: int) -> list:
    """n tokens of a seeded draw, none of them the end-of-sequence id 2."""
    rng = np.random.default_rng(n)
    return rng.integers(3, vocab, n).tolist()


def test_tiny_shapes_are_the_families():
    """The tiny configurations keep what sets each family apart: MHA and
    48 w2 chunks; four query heads a KV head and a vocabulary that is no
    power of two."""
    l2, l3 = _cfgs("llama2")[0], _cfgs("llama3")[0]
    assert l2.kv_repeats == 1 and l3.kv_repeats == 4
    assert l2.hidden_dim // BUCKETS["chunk_rows"] == 48
    assert l3.vocab_size & (l3.vocab_size - 1)
    assert (l2.rope_theta, l3.rope_theta) == (1e4, 5e5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_matches_jax(models, interpret, family):
    """Teacher-forced logits over 8 positions at effort 0.5 on both routes,
    then greedy token ids and every per-step prediction at efforts 0.5 and
    1.0 through the kernel and reference routes and at 1.0 through the
    dense copies."""
    jw, tw = models(family)
    cfg, jcfg = _cfgs(family)
    kc, vc = port_tf.make_kv_cache(cfg, "cpu")
    for jimpl, timpl, tol in (("jnp", "reference", 0.9999),
                              ("pallas", "kernel", 0.999)):
        lj = JaxEngine(jw, jcfg, impl=jimpl, dynamic_effort=True,
                       pad_to=PAD).position_logits(TOKENS, effort=0.5)
        kc.zero_()
        vc.zero_()
        for p, t in enumerate(TOKENS):
            lt = port_tf.forward_token(tw, cfg, t, p, kc, vc, effort=0.5,
                                       impl=timpl).numpy()
            assert cos(lj[p], lt) > tol, (timpl, p, cos(lj[p], lt))
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
    assert (rt.token_ids, rt.predictions) == (rj.token_ids, rj.predictions)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_fills_context_matches_jax(models, interpret, full_tau,
                                           family):
    """Engine(prefill=True) with a prompt of max_seq_len - n_new tokens,
    so its decode steps reach the cache's last slot: token ids and every
    per-step prediction equal JAX's at effort 0.5 on the kernel and
    reference routes and at 1.0 on the dense copies, at tau = 1
    (full_tau)."""
    jw, tw = models(family)
    cfg, jcfg = _cfgs(family)
    prompt = _prompt(cfg.vocab_size, SEQ - N_NEW)
    for jimpl, timpl, effort in (("pallas", "kernel", 0.5),
                                 ("jnp", "reference", 0.5),
                                 ("dense", "dense", 1.0)):
        rj = JaxEngine(jw, jcfg, impl=jimpl, prefill=True,
                       prefill_impl=jimpl, pad_to=PAD).generate(
            prompt, n_new=N_NEW, effort=effort)
        rt = Engine(tw, cfg, impl=timpl, prefill=True, prefill_impl=timpl,
                    pad_to=PAD, device="cpu").generate(prompt, n_new=N_NEW,
                                                       effort=effort)
        assert rt.token_ids == rj.token_ids, (timpl, effort)
        assert rt.predictions == rj.predictions, (timpl, effort)
        assert len(rt.token_ids) == N_NEW
        assert len(rt.predictions) == len(prompt) + N_NEW - 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_engine_matches_jax(models, family):
    """Three requests at mixed efforts through four slots, one of them
    filling the context: the tokens equal JAX's BatchEngine(impl="jnp",
    prefill_impl="jnp") on the port's reference route."""
    jw, tw = models(family)
    cfg, jcfg = _cfgs(family)
    prompts = [PROMPT, _prompt(cfg.vocab_size, SEQ - N_NEW),
               _prompt(cfg.vocab_size, 11)]
    efforts = [1.0, 0.6, 0.5]
    jcb = JaxBatcher(JaxBatchEngine(jw, jcfg, batch_size=4, pad_to=PAD,
                                    impl="jnp", prefill_impl="jnp"))
    cb = ContinuousBatcher(BatchEngine(tw, cfg, batch_size=4, pad_to=PAD,
                                       impl="reference",
                                       prefill_impl="reference",
                                       device="cpu"))
    ref, got = {}, {}
    for i, (p, e) in enumerate(zip(prompts, efforts)):
        jcb.submit(p, N_NEW, e, lambda toks, i=i: ref.__setitem__(i, toks))
        cb.submit(p, N_NEW, e, lambda toks, i=i: got.__setitem__(i, toks))
    jcb.run_until_drained()
    cb.run_until_drained()
    assert got == ref and len(got) == 3


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_from_hf_matches_jax(tmp_path, family):
    """config_from_hf on the published config.json: the port's config
    equals JAX's field for field, and the family's preset at 32 layers
    (its name aside: a converted checkpoint is named by its model_type),
    with the context capped at 4096 unless given."""
    with open(tmp_path / "config.json", "w") as f:
        json.dump(HF_CONFIGS[family], f)
    port_preset, jax_preset = PRESETS[family]
    for seq in (None, 2048):
        tc = port_convert.config_from_hf(str(tmp_path), seq)
        jc = jax_convert.config_from_hf(str(tmp_path), seq)
        assert tc.as_dict() == dataclasses.asdict(jc)
    tc = port_convert.config_from_hf(str(tmp_path))
    assert tc.name == "llama"
    want = port_preset(n_layers=32)
    assert dataclasses.replace(tc, name=want.name) == want
    assert want.as_dict() == dataclasses.asdict(jax_preset(n_layers=32))


def test_kernel_route_on_shapes_jax_kernel_refuses():
    """A row-prefix matrix whose rows, or probe sample, are not a multiple
    of 128 is one JAX's TPU kernel refuses (supports_fused: Mosaic's
    128-lane tiles), and JAX's "pallas" matvec takes "jnp" there.
    Llama-2-7B's w2 is one: 11008 rows, a probe sample of 3669. The port's
    K1 and K2 take any such shape, so its kernel route runs them (their
    plain versions on the CPU); its reference route gives JAX's "jnp"
    outputs. Here a w2 of 344 rows, 43 chunks of 8, on JAX's bucketize."""
    from effort_tpu.kernels.fused_stream import supports_fused
    from effort_tpu.ops import bucketmul as jax_bucketmul
    from effort_tpu.ops.bucketize import bucketize as jax_bucketize
    from effort_tpu_torch.models.bridge import bucketed_from_numpy
    from effort_tpu_torch.ops import bucketmul as port_bucketmul
    from test_torch_bridge import jax_bm_to_numpy
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    wt = (rng.standard_normal((344, 256)) * 0.02).astype(np.float32)
    jb = jax_bucketize(jnp.asarray(wt), JaxBucketConfig(**BUCKETS))
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    assert not supports_fused(jb) and tb.n_chunks == 43
    V = rng.standard_normal((3, 344)).astype(np.float32)
    for v in V:
        jp = np.asarray(jax_bucketmul.bucket_matvec(jb, jnp.asarray(v), 0.5,
                                                    impl="pallas"))
        jj = np.asarray(jax_bucketmul.bucket_matvec(jb, jnp.asarray(v), 0.5,
                                                    impl="jnp"))
        np.testing.assert_array_equal(jp, jj)
        tv = torch.from_numpy(v)
        tr = port_bucketmul.bucket_matvec(tb, tv, 0.5, impl="reference")
        assert cos(jj, tr.numpy()) >= 0.9999
        tk = port_bucketmul.bucket_matvec(tb, tv, 0.5, impl="kernel")
        torch.testing.assert_close(
            tk, port_fs.mxu_matvec_ref(tb, tv, 0.5), rtol=0, atol=0)
    TV = torch.from_numpy(V)
    torch.testing.assert_close(
        port_bucketmul.bucket_matmul(tb, TV, 0.5, impl="kernel"),
        port_fs.mxu_matvec_batch_ref(tb, TV, 0.5), rtol=0, atol=0)


@pytest.mark.parametrize("in_dim", [344, 4096, 11008, 14336])
def test_probe_sample_reads_the_bucketized_rows(in_dim):
    """The runtime's strided probe sample reads the rows bucketize sampled
    (probe_sample_indices at the 4096-probe budget), for every row count:
    Mistral-7B's w2 (14336: stride 4), Llama-2-7B's (11008: stride 3, 3669
    probes, whose count taken as a budget would give stride 4)."""
    from effort_tpu_torch.ops.layouts import (probe_sample_indices,
                                              sample_stride, strided_sample)
    dims = probe_sample_indices(in_dim, 64, 4096)[:, 0]
    P = len(dims)
    v = torch.arange(in_dim, dtype=torch.float32)
    np.testing.assert_array_equal(strided_sample(v, in_dim, P).numpy(), dims)
    assert sample_stride(in_dim, P) == max(1, -(-in_dim // 4096))


def test_llama2_w2_rows_match_jax_reference(monkeypatch):
    """Llama-2-7B's w2 rows (11008 x 64 here, int8, 43 chunks of 256, 3669
    probes) on JAX's bucketize: JAX's runtime takes its probe stride from
    the 3669 as a budget (4) and its reference route raises on the shapes
    (2752 rows against 3669 probes). With JAX's sample given the stride its
    bucketize took, its reference route gives the port's (cos >= 0.9999);
    the port's kernel route (K1's plain version, at tau = 1 so that it
    streams every selected row) gives them too, within the kernel route's
    0.999 (u rounded to bf16)."""
    from effort_tpu.ops import bucketmul as jax_bucketmul
    from effort_tpu.ops import layouts as jax_layouts
    from effort_tpu.ops.bucketize import bucketize as jax_bucketize
    from effort_tpu_torch.models.bridge import bucketed_from_numpy
    from effort_tpu_torch.ops import bucketmul as port_bucketmul
    from test_torch_bridge import jax_bm_to_numpy
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    wt = (rng.standard_normal((11008, 64)) * 0.02).astype(np.float32)
    jb = jax_bucketize(jnp.asarray(wt), JaxBucketConfig(
        bucket_size=1, chunk_rows=256, dtype="int8"))
    tb = bucketed_from_numpy(jax_bm_to_numpy(jb))
    assert tuple(tb.probes.shape) == (1, 3669) and tb.n_chunks == 43

    def sample(v, in_dim, n):
        s = in_dim // n
        return v[..., :n * s:s]
    monkeypatch.setattr(jax_layouts, "strided_sample", sample)
    monkeypatch.setattr(port_fs, "_TAU", 1.0)
    for e in (0.25, 0.5):
        v = rng.standard_normal(11008).astype(np.float32)
        jj = np.asarray(jax_bucketmul.bucket_matvec(jb, jnp.asarray(v), e,
                                                    impl="jnp"))
        tv = torch.from_numpy(v)
        tr = port_bucketmul.bucket_matvec(tb, tv, e, impl="reference")
        assert cos(jj, tr.numpy()) >= 0.9999, e
        tk = port_bucketmul.bucket_matvec(tb, tv, e, impl="kernel")
        assert cos(jj, tk.numpy()) >= 0.999, e
