"""The DeepSeek-V2 architecture (architectures/deepseek_v2.py, its raw
weights and reference/deepseek_v2.py) on a tiny DeepSeek shape on the CPU:
the reference against the port's plain route, the configurations it
refuses, and a chat cell of it run end to end from files and entries
alone."""

import json
import shutil

import pytest
import torch

from architectures import deepseek_v2 as ds
from support import BENCH, DATA, make_copy, run_cpu

from effort_tpu_torch.models.transformer import (embed, forward_layers,
                                                 make_kv_cache, rms_norm)


def _tiny():
    hf = json.loads((DATA / "tiny-deepseek.json").read_text())
    return hf, ds.dims(hf)


def test_reference_follows_the_port_plain_route():
    """The port's plain route (K1's and K9's plain versions through the
    latent cache) and the reference, on the same seed's weights at two
    efforts: the final states through the bf16 head to f32 rounding, and
    the reference's own latent rows against the port's."""
    hf, d = _tiny()
    w, cfg, src = ds.build("tiny-deepseek", d, hf["bucket"], 123, "cpu")
    ref = ds.Reference(src, d, base_rows=32)
    ids = torch.randint(3, 512, (40,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    for effort in (0.25, 0.5):
        cache, _ = make_kv_cache(cfg, "cpu")
        hs = torch.stack([forward_layers(w, cfg, embed(w, t), p, cache, None,
                                         effort=effort, impl="plain")
                          for p, t in enumerate(ids)])
        lp = rms_norm(hs, w.norm, cfg.norm_eps).to(torch.bfloat16).float() \
            @ w.output.float()
        kv_err = []
        lr = ref.forward([ids], [list(range(len(ids)))], effort, 0.97,
                         follow=[(cache[:, :len(ids)],)], kv_err=kv_err)[0]
        # f32 sums in another order (the keys made from the latents, not
        # the query through W_UK); the same selections
        assert (lp - lr).abs().max() <= 5e-3 * lr.abs().max()
        assert torch.equal(lp.argmax(1), lr.argmax(1))
        # the rows are bf16 on both sides: now and then one rounds to the
        # other neighbour
        assert len(kv_err) == d.n_layers
        assert float(torch.cat(kv_err).max()) < 5e-3


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536),
                                       ("scoring_func", "sigmoid"),
                                       ("topk_method", "group_limited_greedy"),
                                       ("n_group", 8)])
def test_a_configuration_the_port_does_not_compute_is_refused(key, value):
    hf, _ = _tiny()
    hf[key] = value
    with pytest.raises(ValueError, match=key):
        ds.dims(hf)


def test_a_deepseek_cell_runs_end_to_end_on_the_cpu(tmp_path):
    """The tiny DeepSeek configuration and a chat cell of it, added to a
    copy as files and entries: a traced run on the CPU is correct, judges
    the latent rows, and reports step_mfu.decode through this
    architecture's work counts."""
    make_copy(tmp_path)
    bench = tmp_path / BENCH.name
    shutil.copy(DATA / "tiny-deepseek.json",
                bench / "configs" / "tiny-deepseek.json")
    (bench / "limits" / "tiny-deepseek.chat.json").write_text(json.dumps(
        {"mean_gap": {"limit": 1.0}, "kv_median": {"limit": 0.05},
         "kv_first_layer_max": {"limit": 0.05}}))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-deepseek", "source": "tests",
                           "reduced": [], "why": "tests",
                           "file": f"{BENCH.name}/configs/tiny-deepseek.json"})
    man["workloads"].append({"name": "tiny-deepseek.chat",
                             "config": "tiny-deepseek",
                             "traffic": "tiny-chat", "chips": 1,
                             "why": "tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "tiny.chat" in m.get("workloads", []):
            m["workloads"].append("tiny-deepseek.chat")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    out, p = run_cpu(tmp_path, ["--workload", "tiny-deepseek.chat", "--seed",
                                str(2**31 + 77), "--seconds", "1",
                                "--trace", "1"])
    assert out is not None, p.stderr[-3000:]
    assert out["correct"] and out["attempted"] > 0, out["compared"]
    assert "step_mfu.decode" in out["metrics"]
    assert out["compared"]["kv_median"]["value"] < 5e-3
