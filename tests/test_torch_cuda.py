"""Tests that need an NVIDIA GPU (`cuda` marker; each skips without one).

This file imports no JAX, so it also runs on a machine without JAX, where
tests/conftest.py cannot load:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from effort_tpu_torch.config import BucketConfig
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import fused_stream as port_fs
from effort_tpu_torch.ops.bucketize import bucketize
from effort_tpu_torch.utils import timing


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_mxu_matvec_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against its plain version on the card: the same
    stream length C and cos >= 0.9999 at every effort and tau."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    wt = torch.randn((4096, 4096), generator=g, device="cuda") * 0.02
    bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=256,
                                    dtype=dtype))
    launches = LAUNCHES["mxu_matvec"]
    for e in (0.1, 0.5, 1.0):
        for tau in (0.97, 1.0):
            v = torch.randn(4096, generator=g, device="cuda")
            y, C = port_fs.mxu_matvec(bm, v, e, 0, tau=tau,
                                      return_len=True)
            yr, Cr = port_fs.mxu_matvec_ref(bm, v, e, 0, tau=tau,
                                            return_len=True)
            torch.cuda.synchronize()
            assert int(C) == int(Cr), (e, tau)
            c = torch.nn.functional.cosine_similarity(
                y.double(), yr.double(), dim=0)
            assert float(c) >= 0.9999, (e, tau, float(c))
    assert LAUNCHES["mxu_matvec"] == launches + 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_mxu_matvec_batch_cuda_kernel_matches_plain(dtype):
    """K2 against its plain version on the card, T in {3, 20} slots with
    mixed efforts (one slot at 0): the same stream length C, cos >= 0.9999
    per non-zero row, exact zeros where the plain version has them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    wt = torch.randn((2048, 3072), generator=g, device="cuda") * 0.02
    bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=256,
                                    dtype=dtype))
    launches = LAUNCHES["mxu_matvec_batch"]
    for T in (3, 20):
        eff = torch.tensor([(0.1, 0.5, 1.0)[t % 3] for t in range(T - 1)]
                           + [0.0], device="cuda")
        for tau in (0.97, 1.0):
            V = torch.randn((T, 2048), generator=g, device="cuda")
            y, C = port_fs.mxu_matvec_batch(bm, V, eff, 0, tau=tau,
                                            return_len=True)
            yr, Cr = port_fs.mxu_matvec_batch_ref(bm, V, eff, 0, tau=tau,
                                                  return_len=True)
            torch.cuda.synchronize()
            assert int(C) == int(Cr), (T, tau)
            for a, b in zip(y, yr):
                if not bool(b.any()):
                    assert not bool(a.any())
                    continue
                c = torch.nn.functional.cosine_similarity(
                    a.double(), b.double(), dim=0)
                assert float(c) >= 0.9999, (T, tau, float(c))
    assert LAUNCHES["mxu_matvec_batch"] == launches + 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("G", [8, 16])
def test_mxu_matvec_batch_tensor_core_edges(dtype, G):
    """K2's tensor-core stream at its edges: T across the n8 and 64-slot
    tiles (1, 3, 8, 20, 65, 130), chunks of 8 or 16 rows (C*G off the
    32-row stage), 640 columns (a ragged column tile; int4 decodes 768,
    past n_buckets). Per call: the plain version's C, cos >= 0.9999 on every
    non-zero row and max|dy| <= 1e-2 max|y_ref|; a slot at effort 0 with a
    zero input gives a row of exact zeros; a second call gives the same
    bits; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(5 + G)
    in_dim, out_dim = 1024, 640
    wt = torch.randn((in_dim, out_dim), generator=g, device="cuda") * 0.02
    bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=G,
                                    dtype=dtype))
    if dtype == "int4":
        assert bm.vals.shape[2] * 2 > bm.n_buckets
    launches = LAUNCHES["mxu_matvec_batch"]
    Ts = (1, 3, 8, 20, 65, 130)
    for T in Ts:
        eff = torch.tensor([(0.1, 0.3, 0.6, 1.0)[t % 4] for t in range(T)],
                           device="cuda")
        V = torch.randn((T, in_dim), generator=g, device="cuda")
        if T > 1:
            eff[T // 2] = 0.0
            V[T // 2] = 0.0
        y, C = port_fs.mxu_matvec_batch(bm, V, eff, 0, tau=0.97,
                                        return_len=True)
        y2 = port_fs.mxu_matvec_batch(bm, V, eff, 0, tau=0.97)
        yr, Cr = port_fs.mxu_matvec_batch_ref(bm, V, eff, 0, tau=0.97,
                                              return_len=True)
        torch.cuda.synchronize()
        assert y.shape == (T, out_dim)
        assert int(C) == int(Cr), (T, int(C), int(Cr))
        assert torch.equal(y, y2), T
        assert float((y - yr).abs().max()) <= 1e-2 * float(yr.abs().max())
        if T > 1:
            assert not bool(yr[T // 2].any()) and not bool(y[T // 2].any())
        for a, b in zip(y, yr):
            if not bool(b.any()):
                assert not bool(a.any())
                continue
            c = torch.nn.functional.cosine_similarity(
                a.double(), b.double(), dim=0)
            assert float(c) >= 0.9999, (T, float(c))
    assert LAUNCHES["mxu_matvec_batch"] == launches + 2 * len(Ts)


@pytest.mark.cuda
@pytest.mark.parametrize("start,mask_from,window", [(0, 5, 0), (40, 0, 0),
                                                    (40, 0, 16)])
def test_flash_attention_cuda_kernel_matches_plain(start, mask_from,
                                                   window):
    """K3 against its plain version on the card (H 8, KV 2, D 64, 24
    queries over a 96-slot cache): allclose at 1e-4, the queries before
    mask_from exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    T, S, H, KV, D = 24, 96, 8, 2, 64
    q = torch.randn((T, H * D), generator=g, device="cuda")
    kc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
    vc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
    launches = LAUNCHES["flash_attention"]
    y = flash_attention_seq(q, kc, vc, start, mask_from, H, D,
                            window=window)
    yr = flash_attention_seq(q, kc, vc, start, mask_from, H, D,
                             window=window, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    dead = max(0, mask_from - start)
    assert not bool(y[:dead].any())
    # the public entry in JAX's layout: Q [KV, rep, T, D], K/V [KV, S, D]
    from effort_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref)
    Q = q.reshape(T, KV, H // KV, D).permute(1, 2, 0, 3)
    K, V = kc.permute(1, 0, 2), vc.permute(1, 0, 2)
    torch.testing.assert_close(
        flash_attention(Q, K, V, start, mask_from, window),
        flash_attention_ref(Q, K, V, start, mask_from, window),
        rtol=1e-4, atol=1e-4)
    assert LAUNCHES["flash_attention"] == launches + 2


# (T, S, start_slot, mask_from, window): a causal prefill; a left-padded
# prompt whose first 9 queries see no key; 40 queries at slot 56 of a
# 96-slot cache; the same in a 16-slot window
FLASH_CASES = ((64, 64, 0, 0, 0), (33, 96, 0, 9, 0), (40, 96, 56, 0, 0),
               (40, 96, 56, 0, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 72, 128, 256])
@pytest.mark.parametrize("pv_f32", [True, False])
def test_flash_attention_tensor_cores_match_plain(D, pv_f32):
    """K3 (mma.sync on the tensor cores) against its plain version at head
    widths 64, 72 (its depth zero-padded to 80), 128 and 256, with GQA (H
    8, KV 2), at FLASH_CASES: min row cos >= 0.9999; max|dy| <= 1e-4
    max|y_ref| under pv_f32 (P kept to about 24 bits as three bf16 parts;
    chip_smoke.py's PV_F32_TOL), 1e-2 without it (P rounded to bf16, against the running max where the
    plain version takes the final one); queries with no live key exactly
    0; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
    g = torch.Generator(device="cuda")
    g.manual_seed(D + pv_f32)
    H, KV = 8, 2
    launches = LAUNCHES["flash_attention"]
    for T, S, start, mf, win in FLASH_CASES:
        q = torch.randn((T, H * D), generator=g, device="cuda") * 2.0
        kc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
        vc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
        args = (q, kc, vc, start, mf, H, D)
        y = flash_attention_seq(*args, window=win, pv_f32=pv_f32)
        yr = flash_attention_seq(*args, window=win, pv_f32=pv_f32,
                                 plain=True)
        torch.cuda.synchronize()
        what = (T, S, start, mf, win)
        dead = max(0, mf - start)
        assert not bool(y[:dead].any()), what
        rows, rows_r = y[dead:].reshape(-1, D), yr[dead:].reshape(-1, D)
        c = torch.nn.functional.cosine_similarity(rows.double(),
                                                  rows_r.double(), dim=1)
        assert float(c.min()) >= 0.9999, (what, float(c.min()))
        tol = 1e-4 if pv_f32 else 1e-2
        err = float((y - yr).abs().max())
        assert err <= tol * float(yr.abs().max()), (what, err)
    assert LAUNCHES["flash_attention"] == launches + len(FLASH_CASES)


# (in_dim, out_dim, chunk_rows): P = 4096 probes at the 4096-wide inputs;
# 112 chunks (w2); 896 chunks of 16 rows, more than a card's SMs, so a
# selection block owns 6 or 7 chunks (an uneven split) and adds its rows'
# masses one by one (G not a multiple of 32); and 4 chunks of 4096 rows, more
# than a block holds in registers (2048), so each block reads its rows after
# the search (row_prefix::chunk_masses from chunk c0 > 0)
K1_SHAPES = ((4096, 6144, 512), (4096, 4096, 128), (14336, 4096, 128),
             (14336, 1024, 16), (16384, 1024, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_mxu_matvec_grid_selection_matches_plain(dtype):
    """K1's selection spread across the card (k1_select_kernel) at
    K1_SHAPES (which reach each of its branches on a 132-SM card), efforts
    0.1, 0.25 and 1 and tau 0.97 and 1: u, read back from the wrapper's
    scratch (fused_stream.mxu_scratch), equal bit for bit to the plain
    selection's (mxu_select_ref), and C and the cutoff equal to it; y
    within cos 0.9999 and max|dy| <= 1e-2 max|y_ref|; the selection's
    ticket back at 0 after each call; two calls in a row on one stream give
    the same bits; v = 0 streams one chunk and gives 0; one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.ops.bucketize import calib_row_order
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launches = LAUNCHES["mxu_matvec"]
    n, ncs, block_rows = 0, [], []
    for in_dim, out_dim, G in K1_SHAPES:
        rms = torch.exp(torch.randn(in_dim, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((in_dim, out_dim), generator=g, device="cuda") * 0.02
        bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=G,
                                        dtype=dtype), in_perm=pi)
        if in_dim == 4096:
            assert bm.probes.shape[1] == 4096
        plan = port_fs.select_plan(bm.n_chunks, sms)
        ncs.append(bm.n_chunks)
        block_rows.append(max(c1 - c0 for c0, c1 in plan) * G)
        v = rms[pi.long()] * torch.randn(in_dim, generator=g, device="cuda")
        for e in (0.1, 0.25, 1.0):
            for tau in (0.97, 1.0):
                y, C = port_fs.mxu_matvec(bm, v, e, 0, tau=tau,
                                          return_len=True)
                sc = port_fs.mxu_scratch(v.device)
                u, cut = sc["u"][:in_dim].clone(), sc["cutoff"].clone()
                ticket = sc["mass"][-1:].view(torch.int32).clone()
                y2 = port_fs.mxu_matvec(bm, v, e, 0, tau=tau)
                n += 2
                ur, Cr, cutr = port_fs.mxu_select_ref(bm, v, e, 0, tau)
                yr = port_fs.mxu_matvec_ref(bm, v, e, 0, tau=tau)
                torch.cuda.synchronize()
                what = (in_dim, out_dim, G, e, tau)
                assert torch.equal(u, ur), what
                assert int(C) == int(Cr), (what, int(C), int(Cr))
                assert torch.equal(cut, cutr), (what, cut, cutr)
                assert not bool(ticket.any()), what
                assert torch.equal(y, y2), what
                c = torch.nn.functional.cosine_similarity(
                    y.double(), yr.double(), dim=0)
                assert float(c) >= 0.9999, (what, float(c))
                err = float((y - yr).abs().max())
                assert err <= 1e-2 * float(yr.abs().max()), (what, err)
        y, C = port_fs.mxu_matvec(bm, torch.zeros_like(v), 0.0, 0,
                                  return_len=True)
        n += 1
        assert int(C) == 1 and not bool(y.any())
    assert 112 in ncs and max(ncs) > sms and max(ncs) % sms
    assert max(block_rows) > 2048
    assert LAUNCHES["mxu_matvec"] - launches == n


@pytest.mark.cuda
def test_forward_seq_kernel_route_matches_plain_route():
    """One batched forward_seq over a left-padded prompt on a small random
    model at tau = 1: the kernel route (K2, K3) against the plain route
    (both plain versions), logits cos >= 0.999 at every real position; K2
    runs 4 times and K3 once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.models import transformer as tf
    cfg = dataclasses.replace(tiny_test_model(), head_dim=128, n_heads=4,
                              n_kv_heads=2, dim=512, hidden_dim=1024)
    w = tf.init_random_weights(cfg, BucketConfig(bucket_size=1,
                                                 chunk_rows=128,
                                                 dtype="int8"),
                               calibrate=True, fuse=True, device="cuda")
    ids = torch.tensor([0] * 5 + list(range(3, 14)), device="cuda")
    saved = port_fs._TAU
    port_fs._TAU = 1.0
    try:
        out = {}
        before = dict(LAUNCHES)
        for impl, attn in (("kernel", "flash"), ("plain", "plain")):
            kc, vc = tf.make_kv_cache(cfg, "cuda")
            out[impl] = tf.forward_seq(w, cfg, ids, kc, vc, rope_offset=5,
                                       mask_from=5,
                                       effort=torch.tensor(0.5,
                                                           device="cuda"),
                                       impl=impl, attn_impl=attn)[5:]
        torch.cuda.synchronize()
    finally:
        port_fs._TAU = saved
    for a, b in zip(out["kernel"], out["plain"]):
        c = torch.nn.functional.cosine_similarity(a.double(), b.double(),
                                                  dim=0)
        assert float(c) >= 0.999
    assert LAUNCHES["mxu_matvec_batch"] - before["mxu_matvec_batch"] == \
        4 * cfg.n_layers
    assert LAUNCHES["flash_attention"] - before["flash_attention"] == \
        cfg.n_layers


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_what_they_do_not_take():
    """On CUDA tensors the K2 and K3 wrappers launch or raise: a V of the
    wrong width, a rank-prefix container, a 16.16 int32 effort (K1's
    form), an f32 cache, a head wider than 256 and one not a multiple of 8
    wide are refused before any launch, with K3's limit in the message,
    and nothing is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    wt = torch.randn((512, 512), generator=g, device="cuda") * 0.02
    bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=128,
                                    dtype="int8"))
    bm4 = bucketize(wt, BucketConfig(bucket_size=4, chunk_rows=16))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError):
        port_fs.mxu_matvec_batch(bm, torch.randn((4, 256), device="cuda"),
                                 0.5)
    with pytest.raises(ValueError):
        port_fs.mxu_matvec_batch(bm4, torch.randn((4, 512), device="cuda"),
                                 0.5)
    with pytest.raises(TypeError):
        port_fs.mxu_matvec_batch(bm, torch.randn((4, 512), device="cuda"),
                                 torch.full((4,), 32768, dtype=torch.int32,
                                            device="cuda"))
    q = torch.randn((8, 4 * 64), device="cuda")
    kc = torch.randn((32, 2, 64), device="cuda")
    with pytest.raises(ValueError):
        flash_attention_seq(q, kc, kc, 0, 0, 4, 64)
    for D in (264, 12):
        kw = torch.randn((32, 2, D), device="cuda").bfloat16()
        with pytest.raises(ValueError, match="from 8 to 256"):
            flash_attention_seq(torch.randn((8, 4 * D), device="cuda"), kw,
                                kw, 0, 0, 4, D)
    assert LAUNCHES == before


@pytest.mark.cuda
def test_forward_seq_auto_attention_is_k3_on_the_card():
    """forward_seq's "auto" attention on the card is K3 for any heads:
    128- and 256-wide heads launch it once a layer, and a 264-wide head,
    which K3 does not take, raises rather than running the plain
    attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.models import transformer as tf
    ids = torch.tensor([0] * 3 + list(range(3, 8)), device="cuda")
    for D, raises in ((128, False), (256, False), (264, True)):
        cfg = dataclasses.replace(tiny_test_model(), head_dim=D, n_heads=2,
                                  n_kv_heads=1, dim=2 * D, hidden_dim=4 * D)
        w = tf.init_random_weights(cfg, BucketConfig(bucket_size=1,
                                                     chunk_rows=8,
                                                     dtype="int8"),
                                   keep_dense=True, device="cuda")
        kc, vc = tf.make_kv_cache(cfg, "cuda")
        before = LAUNCHES["flash_attention"]
        if raises:
            with pytest.raises(ValueError):
                tf.forward_seq(w, cfg, ids, kc, vc, rope_offset=3,
                               mask_from=3, effort=1.0, impl="dense")
        else:
            tf.forward_seq(w, cfg, ids, kc, vc, rope_offset=3, mask_from=3,
                           effort=1.0, impl="dense")
            assert LAUNCHES["flash_attention"] - before == cfg.n_layers


@pytest.mark.cuda
def test_cuda_timers():
    """gpu_ms and chain_time return positive device times, and a chain
    twice as long takes longer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = torch.randn(2048, 2048, device="cuda")
    ms = timing.gpu_ms(lambda x: x @ w, (torch.randn(8, 2048,
                                                        device="cuda"),))
    assert ms > 0

    def make_chain(n):
        def run(v):
            for _ in range(n):
                v = timing.fold_bounce(v @ w, v)
            return v
        return run
    args = [(v,) for v in timing.fresh_vectors((8, 2048), 8)]
    assert timing.chain_time(make_chain, 4, 16, args) > 0


def _rank_container(dtype, seed, in_dim=1024, out_dim=2048, B=4, G=16,
                    percent_load=1.0):
    """A rank-prefix container on the card with a calibrated row order,
    and a matching input (rows scaled by their rms)."""
    from effort_tpu_torch.ops.bucketize import calib_row_order
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rms = torch.exp(torch.randn(in_dim, generator=g, device="cuda") * 1.2)
    pi = calib_row_order(rms)
    wt = torch.randn((in_dim, out_dim), generator=g, device="cuda") * 0.02
    bm = bucketize(wt, BucketConfig(bucket_size=B, chunk_rows=G, dtype=dtype,
                                    percent_load=percent_load), in_perm=pi)
    v = rms[pi.long()] * torch.randn(in_dim, generator=g, device="cuda")
    return bm, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_rank_prefix_stream_cuda_kernels_match_plain(dtype):
    """K4 and K5 against their plain versions on the card (B = 4, G = 16;
    B = 2 and 8; K < B; G = 8, 24 and 64 once each): equal C_k per rank and
    the same y bit for bit (the plain versions add in the kernels' order,
    each sum rounded on its own); K5 on K4's own selection gives K4's
    y."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels import prefix_stream as ps
    before = dict(LAUNCHES)
    n = 0
    for B, pl, G, in_dim in ((4, 1.0, 16, 1024), (2, 1.0, 16, 1024),
                             (8, 1.0, 16, 1024), (4, 0.5, 16, 1024),
                             (4, 1.0, 8, 1024), (4, 1.0, 24, 1536),
                             (4, 1.0, 64, 1024)):
        bm, v = _rank_container(dtype, B + G, in_dim=in_dim, B=B, G=G,
                                percent_load=pl)
        for e in (0.1, 0.5, 1.0):
            for tau in (0.97, 1.0):
                y, C, sel = port_fs.fused_matvec(bm, v, e, 0, tau=tau,
                                                 return_selection=True)
                yr, Cr, _ = port_fs.fused_matvec_ref(
                    bm, v, e, 0, tau=tau, return_selection=True)
                y5 = ps.stream_matvec(bm, sel, 8)
                y5r = ps.stream_matvec_ref(bm, sel, 8)
                torch.cuda.synchronize()
                assert C.tolist() == Cr.tolist(), (B, pl, G, e, tau)
                torch.testing.assert_close(y, yr, rtol=0, atol=0)
                torch.testing.assert_close(y5, y5r, rtol=0, atol=0)
                torch.testing.assert_close(y5, y, rtol=0, atol=0)
                n += 1
    assert LAUNCHES["fused_matvec"] - before["fused_matvec"] == n
    assert LAUNCHES["stream_matvec"] - before["stream_matvec"] == n


# (B, percent_load, G, in_dim, out_dim, experts): K = 1, 2, 4, 8 and 16
# ranks; 201 and 200 chunks, which leave the grid selection's blocks
# unevenly full (one chunk or two) and, at 201, tiles of one 16-row chunk
# (a part-full ring stage); 1040 buckets, which leave the stream's last
# column block part-full; two experts; B = 16 and 32 (two position bytes a
# lane)
K4_CASES = ((2, 0.5, 16, 1024, 2048, 1), (2, 1.0, 16, 3216, 2048, 1),
            (4, 1.0, 16, 3200, 4160, 1), (8, 1.0, 24, 1536, 2048, 2),
            (16, 0.5, 16, 1024, 4096, 1), (32, 0.25, 16, 1024, 4096, 1),
            (16, 1.0, 8, 512, 2048, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_fused_matvec_grid_selection_and_ring_match_plain(dtype):
    """K4 (grid selection, ring stream) against its plain version on the
    card over K4_CASES at efforts 0, 0.25 and 1: C_k, u, cum_tiles,
    base_blocks and y equal bit for bit, the last expert of a two-expert
    container too; at effort 0 on v = 0 every C_k is 1 and y is 0; two
    calls on one input give the same bits; 40 calls in a row on one
    stream, reusing the selection's scratch and ticket, each give their
    plain version's y; K5 on K4's own selection gives K4's y; one launch
    counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels import prefix_stream as ps
    from effort_tpu_torch.ops.bucketize import calib_row_order
    from effort_tpu_torch.ops.bucketmul import _tile_blocks
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    before = LAUNCHES["fused_matvec"]
    n = 0
    for B, pl, G, in_dim, out_dim, E in K4_CASES:
        rms = torch.exp(torch.randn(in_dim, generator=g, device="cuda") * 1.2)
        pi = calib_row_order(rms)
        wt = torch.randn((E, in_dim, out_dim), generator=g,
                         device="cuda") * 0.02
        bm = bucketize(wt, BucketConfig(bucket_size=B, chunk_rows=G,
                                        dtype=dtype, percent_load=pl),
                       in_perm=torch.stack([pi] * E))
        assert bm.n_ranks == max(1, round(pl * B))
        tgb = _tile_blocks(bm)
        expert = E - 1
        v = rms[pi.long()] * torch.randn(in_dim, generator=g, device="cuda")
        for e in (0.0, 0.25, 1.0):
            y, C, sel = port_fs.fused_matvec(bm, v, e, expert, tgb,
                                             return_selection=True)
            y2 = port_fs.fused_matvec(bm, v, e, expert, tgb)
            yr, Cr, selr = port_fs.fused_matvec_ref(bm, v, e, expert, tgb,
                                                    return_selection=True)
            y5 = ps.stream_matvec(bm, sel, tgb)
            torch.cuda.synchronize()
            what = (B, pl, G, in_dim, out_dim, E, e)
            assert C.tolist() == Cr.tolist(), what
            for a, b in zip(sel, selr):
                assert torch.equal(a, b), what
            assert torch.equal(y, yr), what
            assert torch.equal(y2, y), what
            assert torch.equal(y5, y), what
            n += 2
        # an empty selection (v = 0, effort 0) streams one chunk a rank
        y, C, _ = port_fs.fused_matvec(bm, torch.zeros_like(v), 0.0, expert,
                                       tgb, return_selection=True)
        assert C.tolist() == [1] * bm.n_ranks
        assert torch.equal(y, torch.zeros_like(y))
        n += 1
    # many calls in a row on one stream: the scratch and the ticket are
    # reused by every call
    bm, v = _rank_container(dtype, 5)
    vs = [v * (1 + i / 8) for i in range(8)]
    effs = (0.1, 0.3, 0.6, 1.0)
    ys = [port_fs.fused_matvec(bm, vs[i % 8], effs[i % 4], 0)
          for i in range(40)]
    n += 40
    for i in range(8):
        yr = port_fs.fused_matvec_ref(bm, vs[i % 8], effs[i % 4], 0)
        assert torch.equal(ys[i], yr), i
        assert torch.equal(ys[i + 32], ys[i]), i
    assert LAUNCHES["fused_matvec"] - before == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_block_gather_cuda_kernels_match_plain(dtype):
    """K6 and K7 (the ring gather) against their plain versions on the
    card, at G 8 and 16 x B 2 and 4: at capacities that hold every needed
    block, that hold it exactly, and that drop some (n_blocks below, at and
    above the capacity), and on an id list that holds only pads (v = 0,
    n_blocks 0, y exactly 0): the same y bit for bit, K6 and K7 agree
    exactly, and two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels import gather_dma, gather_mul
    from effort_tpu_torch.ops.effort import select_blocks
    before = dict(LAUNCHES)
    n = 0
    for G in (8, 16):
        for B in (2, 4):
            bm, v = _rank_container(dtype, 7 + G + B, B=B, G=G)
            pos = gather_mul.unpacked_positions(bm)
            blocks = bm.blocks_per_expert
            cases = [(0.1, 64), (0.5, blocks), (0.5, 48), (1.0, blocks)]
            for e in (0.25, 0.5):
                need = int(select_blocks(bm, v, e, 0, blocks).n_blocks)
                cases += [(e, need + 16), (e, need), (e, max(1, need - 8))]
            for e, cap in cases:
                sel = select_blocks(bm, v, e, 0, cap)
                y6 = gather_dma.gather_matvec_dma(bm, sel)
                y6b = gather_dma.gather_matvec_dma(bm, sel)
                y7 = gather_mul.gather_bucket_matvec(bm, sel, pos)
                y6r = gather_dma.gather_matvec_dma_ref(bm, sel)
                y7r = gather_mul.gather_bucket_matvec_ref(bm, sel, pos)
                torch.cuda.synchronize()
                what = (G, B, e, cap, int(sel.n_blocks))
                assert torch.equal(y6, y6r), what
                assert torch.equal(y7, y7r), what
                assert torch.equal(y7, y6), what
                assert torch.equal(y6b, y6), what
                n += 1
            sel = select_blocks(bm, torch.zeros_like(v), 0.0, 0, 32)
            assert int(sel.n_blocks) == 0
            y6 = gather_dma.gather_matvec_dma(bm, sel)
            y7 = gather_mul.gather_bucket_matvec(bm, sel, pos)
            torch.cuda.synchronize()
            assert torch.equal(y6, torch.zeros_like(y6))
            assert torch.equal(y6, gather_dma.gather_matvec_dma_ref(bm, sel))
            assert torch.equal(y7, y6)
    assert LAUNCHES["gather_matvec_dma"] - before["gather_matvec_dma"] == \
        2 * n + 4
    assert LAUNCHES["gather_bucket_matvec"] - \
        before["gather_bucket_matvec"] == n + 4


@pytest.mark.cuda
def test_rank_prefix_wrappers_raise_on_what_they_do_not_take():
    """On CUDA tensors K4-K7 launch or raise: a row-prefix container (K5-K7;
    K4 hands it to K1), an input of the wrong width, int4 values (K6, K7),
    blocks of more rows than a gather stage takes (K6, K7) and weights on
    another device are refused before any launch, and nothing is
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels import gather_dma, gather_mul
    from effort_tpu_torch.kernels import prefix_stream as ps
    from effort_tpu_torch.ops.effort import select_blocks
    bm, v = _rank_container("int8", 3, in_dim=512, out_dim=512)
    bm4, _ = _rank_container("int4", 3, in_dim=512, out_dim=512)
    wt = torch.randn((512, 512), device="cuda") * 0.02
    bm1 = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=128,
                                     dtype="int8"))
    sel = ps.select_stream(bm, v, 0.5, 0)
    blocks = select_blocks(bm, v, 0.5, 0, 64)
    blocks4 = select_blocks(bm4, v, 0.5, 0, 64)
    bm64, v64 = _rank_container("int8", 3, in_dim=512, out_dim=512, G=64)
    blocks64 = select_blocks(bm64, v64, 0.5, 0, 16)
    sel_cpu = ps.StreamSelection(*(t.cpu() for t in sel))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError):
        port_fs.fused_matvec(bm, torch.randn(256, device="cuda"), 0.5)
    with pytest.raises(ValueError):
        port_fs.fused_matvec(bm.to("cpu"), v, 0.5)
    for call in (lambda: ps.stream_matvec(bm1, sel),
                 lambda: ps.stream_matvec(bm.to("cpu"), sel),
                 lambda: ps.stream_matvec(bm, ps.StreamSelection(
                     sel.cum_tiles, sel.base_blocks, sel.u_scaled[:, :4])),
                 lambda: gather_dma.gather_matvec_dma(bm4, blocks4),
                 lambda: gather_mul.gather_bucket_matvec(bm4, blocks4),
                 lambda: gather_dma.gather_matvec_dma(bm64, blocks64),
                 lambda: gather_mul.gather_bucket_matvec(bm64, blocks64),
                 lambda: gather_dma.gather_matvec_dma(bm1, blocks),
                 lambda: gather_dma.gather_matvec_dma(bm.to("cpu"), blocks)):
        with pytest.raises(ValueError):
            call()
    assert LAUNCHES == before
    # the CPU selection runs the plain version and counts nothing
    ps.stream_matvec(bm.to("cpu"), sel_cpu)
    assert LAUNCHES == before


@pytest.mark.cuda
def test_rank_prefix_engine_routes_on_the_card():
    """A small rank-prefix model decodes on the card through "auto" (K4
    only: 4 launches a layer a step with fused projections), "stream" (K5
    only) and "gather" (K6 only); the kernel route matches the plain route
    at tau = 1 (logits cos >= 0.999)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.models import transformer as tf
    from effort_tpu_torch.models.generate import Engine
    cfg = dataclasses.replace(tiny_test_model(), dim=512, hidden_dim=1024)
    w = tf.init_random_weights(cfg, BucketConfig(bucket_size=4, chunk_rows=16,
                                                 dtype="int8"),
                               calibrate=True, fuse=True, device="cuda")
    prompt = [1, 5, 9, 13]
    for impl, name in (("auto", "fused_matvec"), ("stream", "stream_matvec"),
                       ("gather", "gather_matvec_dma")):
        eng = Engine(w, cfg, impl=impl, pad_to=8, eos_id=-1)
        before = dict(LAUNCHES)
        rep = eng.generate(prompt, n_new=4, effort=0.5)
        torch.cuda.synchronize()
        assert len(rep.token_ids) == 4
        got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        steps = 8 + 4 - 1
        assert got[name] == 4 * cfg.n_layers * steps, (impl, got)
        assert sum(got.values()) == got[name], (impl, got)
    saved = port_fs._TAU
    port_fs._TAU = 1.0
    try:
        out = {impl: Engine(w, cfg, impl=impl, pad_to=8).position_logits(
            prompt, effort=0.5) for impl in ("kernel", "plain")}
    finally:
        port_fs._TAU = saved
    for a, b in zip(out["kernel"], out["plain"]):
        c = a @ b / ((a @ a) ** 0.5 * (b @ b) ** 0.5)
        assert c >= 0.999
