"""The frozen reference against the port's plain route on tiny shapes.

The test imports both; the reference itself imports nothing of the
program. The quantization and the selection must give the port's
numbers bit for bit on one matrix, and the whole teacher-forced pass the
port's plain route's logits to f32 rounding (same selections)."""

import pytest
import torch

from harness import program
from harness.spec import dims_of
from reference import effort as fx
from reference.model import Reference

from effort_tpu_torch.config import BucketConfig
from effort_tpu_torch.kernels import fused_stream
from effort_tpu_torch.models.transformer import (forward_token,
                                                 make_kv_cache, rms_norm)
from effort_tpu_torch.ops.bucketize import bucketize, calib_row_order

TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
            rms_norm_eps=1e-5, rope_theta=1e6, max_position_embeddings=256,
            sliding_window=None)


@pytest.mark.parametrize("shape", [(256, 384), (512, 256)])
def test_quantize_and_select_match_the_port(shape):
    g = torch.Generator().manual_seed(3)
    i, o = shape
    rms = torch.exp(torch.randn(i, generator=g) * 1.2)
    wt = torch.randn(i, o, generator=g) * 0.02
    pi = calib_row_order(rms)
    assert torch.equal(fx.calib_order(rms), pi.long())
    G = fx.chunk_rows(i, o, 32)
    bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=G,
                                    probes=128, dtype="int8"), in_perm=pi)
    mat = fx.quantize(wt[pi.long()], n_probes=128, base_rows=32)
    assert mat.G == bm.chunk_rows
    assert torch.equal(mat.scale, bm.scales[0, :, 0])
    assert torch.equal(mat.stats, bm.stats[0, :, 0])
    assert torch.equal(mat.probes, bm.probes[0])
    assert torch.equal(mat.codes.to(torch.int8),
                       bm.vals[:-1].reshape(-1, o)[:i])
    for effort in (0.1, 0.25, 0.5):
        v = rms[pi.long()] * torch.randn(i, generator=g)
        u, C, cut = fused_stream.mxu_select_ref(bm, v, effort, 0,
                                                tau=0.97)
        ur, x, sel = fx.select(mat, v[None], effort)
        rows = fx.coverage_rows(mat, x, sel, 0.97)
        assert torch.equal(ur[0], u.float())
        assert int(rows[0]) == int(C) * mat.G
        y = fused_stream.mxu_matvec_ref(bm, v, effort, 0, tau=0.97)
        yr = fx.matmul(mat, v[None], effort, 0.97)[0]
        assert torch.allclose(y, yr, rtol=1e-5, atol=1e-6 * float(
            y.abs().max()))


@pytest.mark.parametrize("experts", [1, 4])
def test_reference_follows_the_port_plain_route(experts):
    hf = dict(TINY)
    if experts > 1:
        hf.update(num_local_experts=experts, num_experts_per_tok=2)
    d = dims_of(hf)
    w, cfg, src = program.build("tiny", d, dict(
        bucket_size=1, chunk_rows=32, probes=4096, dtype="int8"), 123,
        "cpu")
    ref = Reference(src, d, base_rows=32)
    ids = torch.randint(3, 512, (48,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    for effort in (0.25, 0.5):
        kc, vc = make_kv_cache(cfg, "cpu")
        hs = torch.stack([forward_token(w, cfg, t, p, kc, vc, effort=effort,
                                        impl="plain", collect_h=True)[1][-1]
                          for p, t in enumerate(ids)])
        # the port's final state through the exact bf16 head, as the
        # reference's head computes
        lp = rms_norm(hs, w.norm, cfg.norm_eps).to(torch.bfloat16).float() \
            @ w.output.float()
        lr = ref.forward([ids], [list(range(len(ids)))], effort, 0.97)[0]
        # f32 sums in another order; now and then an element of the state
        # rounds to the other bf16 neighbour at the head
        assert (lp - lr).abs().max() <= 5e-3 * lr.abs().max()
        assert torch.equal(lp.argmax(1), lr.argmax(1))
