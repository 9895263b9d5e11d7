"""The port's eval harness, golden-state tester, numpy oracle and
auto-tuner held against the JAX package's on tiny_test_model: JAX's
tests/test_eval.py (15), test_tester.py (2) and test_autotune.py (4) on
the port, then parity with JAX on the same weights and inputs.

Weights cross from JAX by the bridge; the port's "reference" route pairs
with JAX's "jnp". Tolerances, stated per test: matrix_quality_sweep within
1e-5; agreement, tf agreement and quiz scores exactly; KL and NLL within
1e-4 absolute plus 1e-3 relative (the logits agree at cos >= 0.9999, as in
the model tests, and these sums inherit that spread); streamed_fraction
within 1e-3; the oracles' arrays and the ladder exactly; golden files
verify across the two packages with no drift.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.config import BucketConfig as JaxBucketConfig
from effort_tpu.config import ModelConfig as JaxModelConfig
from effort_tpu.config import tiny_test_model as jax_tiny
from effort_tpu.eval import harness as jax_harness
from effort_tpu.models import autotune as jax_autotune
from effort_tpu.models import tester as jax_tester
from effort_tpu.models import transformer as jax_tf
from effort_tpu.models.generate import Engine as JaxEngine
from effort_tpu.ops import oracle as jax_oracle
from effort_tpu.ops.bucketize import bucketize as jax_bucketize
from effort_tpu_torch.config import BucketConfig, ModelConfig, tiny_test_model
from effort_tpu_torch.eval import harness
from effort_tpu_torch.eval.harness import (agreement_sweep, effort_scale,
                                           kl_divergence_sweep, load_quiz,
                                           log_softmax, matrix_quality_sweep,
                                           run_quiz)
from effort_tpu_torch.models import autotune, tester
from effort_tpu_torch.models.autotune import (_ladder,
                                              choose_operating_point,
                                              expand_rows)
from effort_tpu_torch.models.bridge import (bucketed_from_numpy,
                                            model_weights_from_numpy)
from effort_tpu_torch.models.generate import Engine
from effort_tpu_torch.models.transformer import init_random_weights
from effort_tpu_torch.ops import oracle
from effort_tpu_torch.ops.bucketize import bucketize
from test_torch_bridge import REPO, jax_bm_to_numpy, jax_weights_to_numpy

torch.set_num_threads(2)

DATA = os.path.join(REPO, "effort_tpu_torch", "eval", "data")
JAX_DATA = os.path.join(REPO, "effort_tpu", "eval", "data")
QUIZ = os.path.join(DATA, "quiz.json")
IDS = [1, 5, 9, 2, 7]
TEXT = [1, 5, 9, 2, 7, 3, 8, 4, 6, 2, 5, 1]


@pytest.fixture(scope="module")
def engines():
    """(JAX Engine "jnp", port Engine "reference") on one B = 4 model
    with dense copies (JAX's test_eval fixture), pad_to 8."""
    jw = jax_tf.init_random_weights(
        jax_tiny(), JaxBucketConfig(bucket_size=4, chunk_rows=8),
        keep_dense=True)
    tw = model_weights_from_numpy(jax_weights_to_numpy(jw))
    return (JaxEngine(jw, jax_tiny(), impl="jnp", pad_to=8),
            Engine(tw, tiny_test_model(), impl="reference", pad_to=8,
                   device="cpu"))


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def close(a: dict, b: dict, atol: float, rtol: float = 0.0) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= atol + rtol * abs(b[k]), (k, a[k], b[k])


# ---- JAX's tests/test_eval.py, on the port -----------------------------

def test_effort_scale_shape():
    s = effort_scale()
    assert s[0] == 1.0 and min(s) <= 0.03
    assert all(a > b for a, b in zip(s, s[1:]))
    assert s == jax_harness.effort_scale()


def test_matrix_quality_sweep(rng):
    """On the port's own bucketize: cos 1 at full effort, lower effort no
    better; then on JAX's container (bridged), JAX's values within
    1e-5."""
    wt = (rng.standard_normal((64, 256)) * 0.02).astype(np.float32)
    v = rng.standard_normal(64).astype(np.float32)
    bm = bucketize(torch.from_numpy(wt), BucketConfig(bucket_size=4,
                                                      chunk_rows=8))
    out = matrix_quality_sweep(bm, v, efforts=[1.0, 0.5, 0.2], wt_dense=wt)
    assert out[1.0] > 0.999
    assert out[1.0] >= out[0.2] - 1e-6
    jb = jax_bucketize(jnp.asarray(wt), JaxBucketConfig(bucket_size=4,
                                                        chunk_rows=8))
    want = jax_harness.matrix_quality_sweep(jb, jnp.asarray(v),
                                            efforts=[1.0, 0.5, 0.2],
                                            wt_dense=wt)
    got = matrix_quality_sweep(bucketed_from_numpy(jax_bm_to_numpy(jb)), v,
                               efforts=[1.0, 0.5, 0.2], wt_dense=wt)
    close(got, want, 1e-5)


def test_agreement_sweep(engines):
    """The control agrees with itself; JAX's values exactly."""
    je, te = engines
    out = agreement_sweep(te, [1, 5, 9], n_tokens=4, efforts=[1.0, 0.4])
    assert out[1.0] == 1.0
    assert 0.0 <= out[0.4] <= 1.0
    assert out == jax_harness.agreement_sweep(je, [1, 5, 9], n_tokens=4,
                                              efforts=[1.0, 0.4])


def test_quiz_data_wellformed():
    """The port's copies of the data files are the JAX package's, byte
    for byte, and well formed."""
    for fn in ("quiz.json", "basic.json", "article.json"):
        with open(os.path.join(DATA, fn), "rb") as a, \
                open(os.path.join(JAX_DATA, fn), "rb") as b:
            assert a.read() == b.read(), fn
    for fn in ("quiz.json", "basic.json"):
        quiz = load_quiz(os.path.join(DATA, fn))
        assert len(quiz) >= 30
        for item in quiz:
            assert 0 <= item["correct"] < len(item["answers"])


def test_log_softmax_normalizes(rng):
    x = rng.standard_normal((5, 32)) * 3
    lp = log_softmax(x)
    np.testing.assert_allclose(np.exp(lp).sum(-1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(lp, jax_harness.log_softmax(x))


def test_kl_divergence_sweep(engines):
    """KL 0 at full effort, non-negative, growing as effort falls; JAX's
    values within 1e-4 + 1e-3 relative."""
    je, te = engines
    out = kl_divergence_sweep(te, IDS, efforts=[1.0, 0.5, 0.2])
    assert abs(out[1.0]) < 1e-9
    assert out[0.5] >= -1e-12 and out[0.2] >= -1e-12
    assert out[0.2] >= out[0.5] - 1e-9
    close(out, jax_harness.kl_divergence_sweep(je, IDS,
                                               efforts=[1.0, 0.5, 0.2]),
          1e-4, 1e-3)


def test_position_logits_matches_prompt_logits(engine):
    ids = [1, 5, 9, 2]
    pl = engine.position_logits(ids, effort=0.6)
    last, preds = engine.prompt_logits(ids, effort=0.6)
    assert pl.shape == (len(ids), engine.cfg.vocab_size)
    np.testing.assert_allclose(pl[-1], last, rtol=1e-5, atol=1e-5)
    assert [int(np.argmax(row)) for row in pl] == preds


class _FakeTok:
    """Maps text to stable pseudo-ids (the tiny model has no tokenizer)."""
    def encode(self, text, bos=True):
        ids = [1] if bos else []
        ids += [17 + (hash(w) % 400) for w in text.split()][:12]
        return ids or [3]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_run_quiz_mechanism(engines):
    """Scores in [0, 1] per effort; JAX's scores exactly."""
    je, te = engines
    quiz = load_quiz(QUIZ)[:3]
    scores = run_quiz(te, quiz, _FakeTok(), efforts=[1.0, 0.3])
    assert set(scores) == {1.0, 0.3}
    assert all(0.0 <= v <= 1.0 for v in scores.values())
    assert scores == jax_harness.run_quiz(je, quiz, _FakeTok(),
                                          efforts=[1.0, 0.3])


def test_engine_score_logprobs(engine):
    lp = engine.score(IDS, effort=1.0)
    assert lp.shape == (len(IDS) - 1,)
    assert np.all(lp <= 0.0)
    pl = engine.position_logits(IDS, effort=1.0)
    want = log_softmax(pl[:-1])[np.arange(len(IDS) - 1), IDS[1:]]
    np.testing.assert_allclose(lp, want, rtol=1e-5, atol=1e-5)


def test_nll_sweep(engines):
    """NLL in nats, positive; JAX's values within 1e-4 + 1e-3 relative."""
    je, te = engines
    out = harness.nll_sweep(te, IDS, efforts=[1.0, 0.3])
    assert set(out) == {1.0, 0.3}
    assert all(v > 0 for v in out.values())
    close(out, jax_harness.nll_sweep(je, IDS, efforts=[1.0, 0.3]), 1e-4,
          1e-3)


def test_tf_agreement_sweep(engines):
    """Agreement 1 at full effort by construction; JAX's values exactly,
    with the engine's own control and with JAX's control passed in."""
    je, te = engines
    out = harness.tf_agreement_sweep(te, TEXT, efforts=[1.0, 0.4])
    assert out[1.0] == 1.0
    assert 0.0 <= out[0.4] <= 1.0
    control = jax_harness.tf_control_preds(je, TEXT)
    assert harness.tf_control_preds(te, TEXT) == control
    assert out == jax_harness.tf_agreement_sweep(je, TEXT,
                                                 efforts=[1.0, 0.4])
    assert harness.tf_agreement_sweep(te, TEXT, efforts=[0.4],
                                      control=control)[0.4] == out[0.4]


def test_streamed_fraction_bounds(engines):
    """Fractions in (0, 1]; higher effort never selects fewer rows; w2
    keys on the unfused layout; JAX's values within 1e-3."""
    je, te = engines
    kw = dict(efforts=(0.5, 0.25), n_probe_tokens=3)
    out = harness.streamed_fraction(te.w, te.cfg, list(range(1, 13)),
                                    device="cpu", **kw)
    for tag in (50, 25):
        f = out[f"streamed_chunk_frac_{tag}"]
        assert 0.0 < f <= 1.0, (tag, f)
        assert 0.0 <= out[f"selected_row_frac_{tag}"] <= 1.0
        assert 0.0 < out[f"w2_streamed_chunk_frac_{tag}"] <= 1.0
    assert (out["selected_row_frac_50"]
            >= out["selected_row_frac_25"] - 1e-6)
    want = jax_harness.streamed_fraction(je.w, je.cfg, list(range(1, 13)),
                                         **kw)
    close(out, want, 1e-3)


def test_decode_speed_sweep_structure(engine):
    """Timings are not measurements on the CPU; the keys and the dense and
    effort paths must still run end to end."""
    out = harness.decode_speed_sweep(engine.w, engine.cfg,
                                     efforts=(1.0, 0.5), impl="reference",
                                     n_lo=2, n_hi=4, device="cpu")
    assert "dense_toks_per_s" in out
    for tag in (100, 50):
        assert out[f"toks_per_s_{tag}"] > 0
        assert f"speedup_vs_dense_{tag}" in out


def _scripted_clock(durations):
    """A stand-in for decode_speed_sweep's clock: each timed run (a clock
    read before it and one after) lasts the next of `durations`."""
    it, now, start = iter(durations), [0.0], [True]

    def clock():
        if not start[0]:
            now[0] += next(it)
        start[0] = not start[0]
        return now[0]
    return clock


def test_decode_speed_sweep_retimes_a_negative_slope(engine, monkeypatch):
    """A clock under which the 2-step runs first take longer than the
    4-step ones: both lengths are timed again, and the slope of the second
    try is the one returned. Runs: two warm-ups, then 3 at n_lo and 3 at
    n_hi a try."""
    monkeypatch.setattr(harness, "_clock", _scripted_clock(
        [1, 1] + [5, 5, 5, 1, 1, 1] + [1, 2, 1, 3, 4, 3]))
    out = harness.decode_speed_sweep(engine.w, engine.cfg, efforts=(0.5,),
                                     include_dense=False, impl="reference",
                                     n_lo=2, n_hi=4, device="cpu")
    assert out == {"toks_per_s_50": 1.0}   # (min 3 - min 1) / (4 - 2)


def test_decode_speed_sweep_raises_without_a_positive_slope(engine,
                                                            monkeypatch):
    """A slope that is never positive (the longer runs never slower) raises
    after _SLOPE_TRIES tries, each of 3 runs a length."""
    monkeypatch.setattr(harness, "_clock", _scripted_clock(
        [1, 1] + [2, 2, 2, 2, 2, 2] * harness._SLOPE_TRIES))
    with pytest.raises(RuntimeError, match="never took longer"):
        harness.decode_speed_sweep(engine.w, engine.cfg, efforts=(0.5,),
                                   include_dense=False, impl="reference",
                                   n_lo=2, n_hi=4, device="cpu")


def test_limited_quiz_sweep_counts():
    """A stub engine that knows the answers at high effort and guesses
    slot 0 at low effort."""
    class Stub:
        def answer_limited(self, prompt_ids, allowed_ids, effort=1.0):
            return prompt_ids[0] if effort >= 0.5 else 0

    items = [{"prompt_ids": [i % 3], "allowed_ids": [10, 11, 12],
              "correct": i % 3} for i in range(9)]
    acc = harness.limited_quiz_sweep(Stub(), items, efforts=[1.0, 0.1])
    assert acc[1.0] == 1.0
    assert abs(acc[0.1] - 3 / 9) < 1e-9
    assert acc == jax_harness.limited_quiz_sweep(Stub(), items,
                                                 efforts=[1.0, 0.1])


def test_build_fact_quiz_items_single_token_answers():
    """build_fact_quiz's items through the port's WordTokenizer:
    single-token answers, four choices, no leak of the answer id."""
    sys.path.insert(0, REPO)
    from scripts.trained_quiz import build_fact_quiz, quiz_items
    from effort_tpu_torch.runtime.word_tokenizer import WordTokenizer

    words = ([f" word{chr(97+i)}" for i in range(26)]
             + ["the", " the", " of", " is", "plain"])
    facts = build_fact_quiz(words, n_facts=8, seed=1)
    tok = WordTokenizer(words)
    for f in facts:
        assert f["val"].startswith(" ")
        assert tok.encode(f["val"]) == [f["val_id"]], f
    for it, f in zip(quiz_items(facts, tok), facts):
        assert len(it["allowed_ids"]) == 4
        assert it["allowed_ids"][it["correct"]] == f["val_id"]
        assert f["val_id"] not in it["prompt_ids"]


# ---- models/tester.py ---------------------------------------------------

def _tiny_port(seed: int = 0):
    return init_random_weights(tiny_test_model(), BucketConfig(
        bucket_size=4, chunk_rows=8), seed=seed, device="cpu")


def test_golden_roundtrip(tmp_path):
    """An identical rerun verifies clean; other weights are caught."""
    cfg, w = tiny_test_model(), _tiny_port()
    states = tester.capture_states(w, cfg, [1, 5, 9], effort=1.0,
                                   device="cpu")
    assert f"h_tok0_lay{cfg.n_layers - 1}" in states
    tester.save_states(str(tmp_path), states)
    rep = tester.verify_states(str(tmp_path), tester.capture_states(
        w, cfg, [1, 5, 9], effort=1.0, device="cpu"))
    assert rep.passed and rep.drift == 0, str(rep)
    rep = tester.verify_states(str(tmp_path), tester.capture_states(
        _tiny_port(seed=9), cfg, [1, 5, 9], effort=1.0, device="cpu"))
    assert not rep.passed
    assert rep.drift > 0 or rep.failures


def test_low_effort_drifts_but_logits_close(tmp_path):
    cfg, w = tiny_test_model(), _tiny_port()
    tester.save_states(str(tmp_path), tester.capture_states(
        w, cfg, [1, 5], effort=1.0, device="cpu"))
    rep = tester.verify_states(str(tmp_path), tester.capture_states(
        w, cfg, [1, 5], effort=0.7, device="cpu"), threshold=0.8)
    assert rep.compared > 0


def test_golden_files_cross_packages(tmp_path, engines):
    """A golden file written by JAX verifies in the port (same weights,
    effort 1.0: passed, no drift, every key compared) and the port's in
    JAX; the same file names and keys; the threshold 0.99 of both."""
    je, te = engines
    js = jax_tester.capture_states(je.w, je.cfg, [1, 5, 9], effort=1.0)
    ts = tester.capture_states(te.w, te.cfg, [1, 5, 9], effort=1.0,
                               device="cpu")
    assert sorted(js) == sorted(ts)
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    assert jax_tester.save_states(str(a), js) == tester.save_states(str(b),
                                                                    ts)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    rep = tester.verify_states(str(a), ts)
    assert rep.passed and rep.drift == 0 and rep.compared == len(js), rep
    rep = jax_tester.verify_states(str(b), js)
    assert rep.passed and rep.drift == 0 and rep.compared == len(ts), rep


# ---- ops/oracle.py ------------------------------------------------------

@pytest.mark.parametrize("B", [1, 4])
def test_oracles_match_jax(B):
    """bucketize_oracle, cutoff_oracle, row_rank_counts_oracle and
    bucketmul_oracle give JAX's arrays exactly on the same numpy inputs."""
    rng = np.random.default_rng(B)
    wt = (rng.standard_normal((48, 64)) * 0.02).astype(np.float32)
    v = rng.standard_normal(48).astype(np.float32)
    got = oracle.bucketize_oracle(wt, B, n_probes=16)
    want = jax_oracle.bucketize_oracle(wt, B, n_probes=16)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    vals, pos, stats, probes, pdims = got
    for e in (1.0, 0.5, 0.2):
        c = oracle.cutoff_oracle(v, probes, pdims, e)
        assert c == jax_oracle.cutoff_oracle(v, probes, pdims, e)
        np.testing.assert_array_equal(
            oracle.row_rank_counts_oracle(v, stats, c),
            jax_oracle.row_rank_counts_oracle(v, stats, c))
        np.testing.assert_array_equal(
            oracle.bucketmul_oracle(v, *got, e),
            jax_oracle.bucketmul_oracle(v, *want, e))


# ---- models/autotune.py -------------------------------------------------

ROWS = [
    {"config": "bf16 tau=0.97", "toks_per_s_50": 700.0,
     "toks_per_s_25": 740.0, "agreement_vs_full_50": 0.95,
     "agreement_vs_full_25": 0.84, "speedup_vs_full_dense_25": 1.01},
    {"config": "int8 percent_load=0.688", "toks_per_s_50": 1200.0,
     "toks_per_s_25": 1600.0, "agreement_vs_full_50": 0.88,
     "agreement_vs_full_25": 0.71, "speedup_vs_full_dense_25": 2.19},
    {"config": "int4 percent_load=0.688", "toks_per_s_50": 1500.0,
     "toks_per_s_25": 2000.0, "agreement_vs_full_50": 0.62,
     "agreement_vs_full_25": 0.41},
]


def test_expand_rows():
    pts = expand_rows(ROWS)
    assert len(pts) == 6
    by = {(p["config"], p["effort"]): p for p in pts}
    assert by[("bf16 tau=0.97", 0.25)]["agreement"] == 0.84
    assert by[("int8 percent_load=0.688", 0.25)]["speedup"] == 2.19
    assert pts == jax_autotune.expand_rows(ROWS)


def test_choose_respects_floor():
    pts = expand_rows(ROWS)
    c = choose_operating_point(pts, target_agreement=0.8)
    assert c["config"].startswith("int8") and c["effort"] == 0.5, c
    c = choose_operating_point(pts, target_agreement=0.9)
    assert c["config"].startswith("bf16") and c["effort"] == 0.5, c
    c = choose_operating_point(pts, target_agreement=None)
    assert c["config"].startswith("int4") and c["effort"] == 0.25, c
    assert choose_operating_point(pts, target_agreement=0.99) is None
    for t in (0.8, 0.9, None, 0.99, 0.5):
        assert choose_operating_point(pts, t) == \
            jax_autotune.choose_operating_point(pts, t)


def test_choose_skips_unmeasured_agreement_under_floor():
    pts = [{"config": "x", "effort": 0.25, "toks_per_s": 9999.0,
            "agreement": None},
           {"config": "y", "effort": 0.5, "toks_per_s": 100.0,
            "agreement": 0.9}]
    assert choose_operating_point(pts, target_agreement=0.8)["config"] == "y"
    assert choose_operating_point(pts, target_agreement=None)[
        "config"] == "x"


def test_ladder_hbm_budget_filters(tmp_path):
    """A memory budget analytically excludes configs that cannot fit; the
    candidates equal JAX's _ladder's at every budget."""
    kw = dict(name="t", dim=4096, hidden_dim=14336, n_layers=32,
              n_heads=32, n_kv_heads=8, head_dim=128, vocab_size=32000)
    cfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    ck = tmp_path / "ckpt_bf16"
    for d in (ck, tmp_path / "ckpt_int8"):
        d.mkdir()
        (d / "config.json").write_text("{}")
    no_budget = _ladder(str(ck), None, cfg, (0.25,))
    assert {c["dtype"] for c in no_budget} == {"int8", "bf16"}
    tight = _ladder(str(ck), 8 * 2**30, cfg, (0.25,))
    dts = [(c["dtype"], c["percent_load"]) for c in tight]
    assert ("bf16", 1.0) not in dts
    assert any(d == "int8" for d, _ in dts)
    for budget in (None, 8 * 2**30, 5 * 2**30, 2**30):
        assert _ladder(str(ck), budget, cfg, (0.25,)) == \
            jax_autotune._ladder(str(ck), budget, jcfg, (0.25,))


def test_auto_tune_end_to_end(tmp_path):
    """auto_tune on a tiny bf16 checkpoint with an int8 sibling and a
    corpus.npy beside them (all converted by the port on the CPU): four
    candidates (int8 and bf16 at percent_load 11/16 and 1) x 3 efforts
    measured, agreement scored against the bf16 control, a point chosen
    (a floor of 0 admits every measured point); progress on stderr.
    Each point's agreement equals tf_agreement_sweep's, recomputed here
    on the candidate's own load against the bf16 control, which is JAX's
    control on the same files exactly (both take the dense copies at
    1.0) and agrees with itself at 1.0."""
    from effort_tpu_torch.convert.convert import convert_checkpoint
    from test_torch_convert import write_hf_checkpoint
    cfg = tiny_test_model()
    src = tmp_path / "hf"
    src.mkdir()
    write_hf_checkpoint(src, cfg, seed=3)
    for dt in ("bf16", "int8"):
        convert_checkpoint(str(src), str(tmp_path / f"ckpt_{dt}"), cfg,
                           BucketConfig(bucket_size=1, chunk_rows=128,
                                        dtype=dt),
                           fuse=True, device="cpu",
                           progress=lambda *a: None)
    np.save(tmp_path / "corpus.npy",
            np.random.default_rng(0).integers(3, 512, 1000))
    lines = []
    res = autotune.auto_tune(str(tmp_path / "ckpt_bf16"),
                             target_agreement=0.0, device="cpu",
                             progress=lines.append)
    assert res["dense_toks_per_s"] > 0
    assert len(res["points"]) == 4 * 3 and len(lines) == 4
    assert {p["config"] for p in res["points"]} == {
        f"{d} percent_load={pl:.3f}" for d in ("int8", "bf16")
        for pl in (11 / 16, 1.0)}
    assert all(0.0 <= p["agreement"] <= 1.0 for p in res["points"])
    assert res["chosen"] in res["points"]
    json.dumps(res)

    from effort_tpu.models import weights as jax_weights
    from effort_tpu_torch.models.weights import (attach_dense,
                                                 load_bucketized,
                                                 truncate_model)
    corpus = np.load(tmp_path / "corpus.npy")
    hold = corpus[980:1480].astype(int).tolist()
    w, tcfg, _ = load_bucketized(str(tmp_path / "ckpt_bf16"),
                                 load_dense=False, device="cpu")
    ctl = Engine(attach_dense(w), tcfg, impl="auto", dynamic_effort=True,
                 eos_id=-1, device="cpu")
    control = harness.tf_control_preds(ctl, hold)
    assert harness.tf_agreement_sweep(ctl, hold, efforts=[1.0],
                                      control=control) == {1.0: 1.0}
    jw, jcfg, _ = jax_weights.load_bucketized(str(tmp_path / "ckpt_bf16"),
                                              load_dense=False)
    assert control == jax_harness.tf_control_preds(
        JaxEngine(jax_weights.attach_dense(jw), jcfg, impl="auto",
                  dynamic_effort=True, eos_id=-1), hold)
    for dt in ("int8", "bf16"):
        for pl in (11 / 16, 1.0):
            wv, cfgv, _ = load_bucketized(str(tmp_path / f"ckpt_{dt}"),
                                          load_dense=False, device="cpu")
            if pl < 1.0:
                wv = truncate_model(wv, pl)
            agr = harness.tf_agreement_sweep(
                Engine(wv, cfgv, impl="auto", dynamic_effort=True,
                       eos_id=-1, device="cpu"),
                hold, efforts=(0.5, 0.35, 0.25), control=control)
            name = f"{dt} percent_load={pl:.3f}"
            assert {p["effort"]: p["agreement"] for p in res["points"]
                    if p["config"] == name} == {
                e: round(a, 3) for e, a in agr.items()}
