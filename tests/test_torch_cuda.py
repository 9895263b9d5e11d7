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
from effort_tpu_torch.ops.bucketize import bucketize, calib_row_order
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("G", [128, 256])
def test_row_prefix_kernels_at_llama2_w2_chunks_match_plain(dtype, G):
    """K1 and K2 on a matrix of Llama-2-7B's w2 rows (11008, a probe sample
    of 3669) at 86 chunks of 128 and 43 of 256 (counts that are no power
    of two; init_random_weights picks 256 at int8), 256 columns, against
    their plain versions: the same stream length C and cos >= 0.9999 (K2 a
    slot, T in {4, 64}) at efforts 0.1, 0.5 and 1.0 and tau 0.97 and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(G)
    rms = torch.exp(torch.randn(11008, generator=g, device="cuda") * 1.2)
    order = calib_row_order(rms).long()
    wt = torch.randn((11008, 256), generator=g, device="cuda") * 0.02
    bm = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=G,
                                    dtype=dtype), in_perm=order)
    assert bm.n_chunks == 11008 // G and bm.probes.shape[1] == 3669
    launches = (LAUNCHES["mxu_matvec"], LAUNCHES["mxu_matvec_batch"])
    for e in (0.1, 0.5, 1.0):
        for tau in (0.97, 1.0):
            v = rms[order] * torch.randn(11008, generator=g, device="cuda")
            y, C = port_fs.mxu_matvec(bm, v, e, 0, tau=tau,
                                      return_len=True)
            yr, Cr = port_fs.mxu_matvec_ref(bm, v, e, 0, tau=tau,
                                            return_len=True)
            torch.cuda.synchronize()
            assert int(C) == int(Cr), (e, tau)
            c = torch.nn.functional.cosine_similarity(
                y.double(), yr.double(), dim=0)
            assert float(c) >= 0.9999, (e, tau, float(c))
            for T in (4, 64):
                V = rms[order] * torch.randn((T, 11008), generator=g,
                                             device="cuda")
                y, C = port_fs.mxu_matvec_batch(bm, V, e, 0, tau=tau,
                                                return_len=True)
                yr, Cr = port_fs.mxu_matvec_batch_ref(bm, V, e, 0, tau=tau,
                                                      return_len=True)
                torch.cuda.synchronize()
                assert int(C) == int(Cr), (e, tau, T)
                c = torch.nn.functional.cosine_similarity(
                    y.double(), yr.double(), dim=1)
                assert float(c.min()) >= 0.9999, (e, tau, T, float(c.min()))
    assert (LAUNCHES["mxu_matvec"], LAUNCHES["mxu_matvec_batch"]) == (
        launches[0] + 6, launches[1] + 12)


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,start,mask_from", [(2304, 2304, 0, 0),
                                                 (300, 4096, 3796, 0),
                                                 (100, 2304, 2000, 37)])
def test_flash_attention_mha_over_long_caches_matches_plain(T, S, start,
                                                            mask_from):
    """K3 with one query head a KV head (rep = 1, Llama-2-7B's attention:
    H = KV = 4 here, D 128) over caches of more than 2048 slots: a whole
    causal prefill, the last queries of a 4096-slot cache, and queries past
    slot 2000 masked below slot 37; min row cos >= 0.9999 and max|dy| <=
    1e-4 max|y_ref| (pv_f32), as the other K3 cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
    g = torch.Generator(device="cuda")
    g.manual_seed(T + S)
    H = KV = 4
    D = 128
    q = torch.randn((T, H * D), generator=g, device="cuda") * 2.0
    kc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
    vc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
    launches = LAUNCHES["flash_attention"]
    y = flash_attention_seq(q, kc, vc, start, mask_from, H, D)
    yr = flash_attention_seq(q, kc, vc, start, mask_from, H, D, plain=True)
    torch.cuda.synchronize()
    c = torch.nn.functional.cosine_similarity(
        y.reshape(-1, D).double(), yr.reshape(-1, D).double(), dim=1)
    assert float(c.min()) >= 0.9999, float(c.min())
    err = float((y - yr).abs().max())
    assert err <= 1e-4 * float(yr.abs().max()), err
    assert LAUNCHES["flash_attention"] == launches + 1


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
    only) and "gather" (K6 only), each beside K8's attention once a layer
    a step; the kernel route matches the plain route at tau = 1 (logits
    cos >= 0.999)."""
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
        assert got["decode_attention"] == cfg.n_layers * steps, (impl, got)
        assert sum(got.values()) == got[name] + got["decode_attention"], (
            impl, got)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_device_instance_equals_int_instance(dtype):
    """K1 and K4 on containers of 3 instances: each instance given as a 0-d
    int32 CUDA tensor gives the int instance's y, C (C_k) and u bit for
    bit, and the instances differ from each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    wt = torch.randn((3, 2048, 1024), generator=g, device="cuda") * 0.02
    v = torch.randn(2048, generator=g, device="cuda")
    bm1 = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=128,
                                     dtype=dtype))
    bm4 = bucketize(wt, BucketConfig(bucket_size=4, chunk_rows=16,
                                     dtype=dtype))
    ys = []
    for e in range(3):
        t = torch.tensor(e, dtype=torch.int32, device="cuda")
        out = []
        for inst in (e, t):
            y, C = port_fs.mxu_matvec(bm1, v, 0.3, inst, return_len=True)
            u = port_fs.mxu_scratch("cuda")["u"][:2048].clone()
            y4, C4, sel = port_fs.fused_matvec(bm4, v, 0.3, inst,
                                               return_selection=True)
            out.append((y, C, u, y4, C4, sel.u_scaled, sel.base_blocks,
                        sel.cum_tiles))
        torch.cuda.synchronize()
        for a, b in zip(*out):
            assert torch.equal(a, b), e
        ys.append(out[0][0])
    assert not torch.equal(ys[0], ys[1]) and not torch.equal(ys[1], ys[2])


def _tiny_moe(B):
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.models import transformer as tf
    cfg = tiny_test_model(n_experts=4, n_experts_per_tok=2, max_seq_len=64)
    bc = BucketConfig(bucket_size=B, chunk_rows=8 if B == 1 else 16,
                      dtype="int8")
    return cfg, tf.init_random_weights(cfg, bc, seed=1, calibrate=True,
                                       fuse=True, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_moe_decode_step_waits_on_no_host_read(B):
    """One MoE decode step (forward_token, K1 or K4 with the routed
    instance on the card) raises nothing under
    torch.cuda.set_sync_debug_mode("error"), and launches 6 kernels a
    layer (wqkv, wo, and w13, w2 of two experts) beside K8's attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.models import transformer as tf
    from effort_tpu_torch.ops.effort import effort_q16
    cfg, w = _tiny_moe(B)
    kc, vc = tf.make_kv_cache(cfg, "cuda")
    eq = effort_q16(0.5, "cuda")
    tok = torch.tensor(5, dtype=torch.int32, device="cuda")
    tf.forward_token(w, cfg, tok, 0, kc, vc, effort=eq)        # warm-up
    torch.cuda.synchronize()
    name = "mxu_matvec" if B == 1 else "fused_matvec"
    before = dict(LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg = tf.forward_token(w, cfg, tok, 1, kc, vc, effort=eq)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(lg).all())
    got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert got[name] == 6 * cfg.n_layers
    assert got["decode_attention"] == cfg.n_layers
    assert sum(got.values()) == got[name] + cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_moe_kernel_route_matches_plain_route(B):
    """A tiny MoE model's kernel route (K1 / K4 with device instances)
    against its plain route at tau = 1: the same top-2 experts at every
    layer and position, logits cos >= 0.999; and the prefill kernel route
    (routing read once a layer, K2 once per expert) against the token
    loop, cos >= 0.999."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.models import transformer as tf
    from effort_tpu_torch.models.generate import Engine
    cfg, w = _tiny_moe(B)
    prompt = [1, 5, 9, 13, 2]
    route = tf.route
    saved = port_fs._TAU
    port_fs._TAU = 1.0
    try:
        out, picks = {}, {}
        for impl in ("kernel", "plain"):
            seen = []

            def record(*args):
                gates, idx = route(*args)
                seen.append(idx)
                return gates, idx
            tf.route = record
            # eager steps: a captured step would run record once
            out[impl] = Engine(w, cfg, impl=impl, pad_to=8,
                               capture=False).position_logits(
                prompt, effort=0.5)
            picks[impl] = torch.stack(seen).tolist()
        if B == 1:
            tf.route = route
            out["prefill"] = Engine(
                w, cfg, impl="kernel", pad_to=8, prefill=True,
                prefill_impl="kernel").position_logits(prompt, effort=0.5)
    finally:
        tf.route = route
        port_fs._TAU = saved
    assert picks["kernel"] == picks["plain"]
    for other in [k for k in out if k != "kernel"]:
        for a, b in zip(out["kernel"], out[other]):
            c = a @ b / ((a @ a) ** 0.5 * (b @ b) ** 0.5)
            assert c >= 0.999, other


@pytest.mark.cuda
def test_instance_wrappers_raise_on_what_they_do_not_take():
    """K1 and K4 refuse an instance tensor that is not one int32 on the
    weights' card; K2 takes an int instance only; nothing is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wt = torch.randn((2, 512, 512), device="cuda") * 0.02
    bm1 = bucketize(wt, BucketConfig(bucket_size=1, chunk_rows=128,
                                     dtype="int8"))
    bm4 = bucketize(wt, BucketConfig(bucket_size=4, chunk_rows=16))
    v = torch.randn(512, device="cuda")
    before = dict(LAUNCHES)
    for bad in (torch.tensor(1, device="cuda"),             # int64
                torch.tensor(1, dtype=torch.int32),          # on the CPU
                torch.tensor([0, 1], dtype=torch.int32, device="cuda"), 2):
        with pytest.raises(ValueError):
            port_fs.mxu_matvec(bm1, v, 0.5, bad)
        with pytest.raises(ValueError):
            port_fs.fused_matvec(bm4, v, 0.5, bad)
    with pytest.raises(TypeError):
        port_fs.mxu_matvec_batch(bm1, v[None], 0.5,
                                 torch.tensor(1, dtype=torch.int32,
                                              device="cuda"))
    assert LAUNCHES == before


def _tiny_dense(device="cuda"):
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.models import transformer as tf
    cfg = tiny_test_model(max_seq_len=64, sliding_window=16)
    w = tf.quantize_head(tf.init_random_weights(
        cfg, BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8"),
        calibrate=True, fuse=True, keep_dense=True, device=device))
    return cfg, w


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [
    {}, {"temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 3},
    {"presence_penalty": 0.5, "frequency_penalty": 0.2, "logprobs": 3}])
def test_engine_captures_the_decode_step(opts):
    """On the card Engine runs each decode step as a replayed CUDA graph,
    one a key: its tokens, predictions and logprobs equal the eager
    steps' (capture=False) bit for bit at efforts 0.25, 0.5 and 1.0
    (dense copies), sampling included (the generator is the graph's), and
    a replayed run counts the launches the eager run counts; new effort
    and sampling values capture nothing; the ring and int8 caches and the
    prefill engine capture too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.models.generate import Engine
    cfg, w = _tiny_dense()
    prompt = [1, 5, 9, 13]
    for kw in ({}, {"ring_kv": True}, {"quant_kv": True},
               {"prefill": True}):
        if kw.get("prefill") and ("logprobs" in opts
                                  or "presence_penalty" in opts):
            continue
        eng = Engine(w, cfg, pad_to=8, eos_id=-1, **kw)
        eager = Engine(w, cfg, pad_to=8, eos_id=-1, capture=False, **kw)
        assert eng.capture and not eager.capture
        for effort in (0.25, 0.5, 1.0):
            eng.generate(prompt, n_new=6, effort=effort, **opts)  # warm
            runs = []
            for e in (eng, eager):
                before = dict(LAUNCHES)
                r = e.generate(prompt, n_new=6, effort=effort, **opts)
                torch.cuda.synchronize()
                runs.append((r, {k: LAUNCHES[k] - before[k]
                                 for k in LAUNCHES}))
            (rg, lg), (re, le) = runs
            what = (kw, effort)
            assert rg.token_ids == re.token_ids, what
            assert rg.predictions == re.predictions, what
            assert rg.logprobs == re.logprobs, what
            assert lg == le, what
        n_graphs = len(eng._graphs)
        assert n_graphs == 2, kw            # kernel route, dense copies
        vary = dict(opts)
        for k in ("temperature", "top_p", "presence_penalty"):
            if k in vary:
                vary[k] = vary[k] * 0.5
        eng.generate(prompt, n_new=6, effort=0.3, **vary)
        assert len(eng._graphs) == n_graphs, kw


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_batch_engine_captures_its_step(kv_dtype):
    """BatchEngine's step runs as one replayed graph: the same requests
    give the eager step's tokens and launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.serving.batcher import (BatchEngine,
                                                  ContinuousBatcher)
    cfg, w = _tiny_dense()
    prompts = [[1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 3], [2, 9]]
    efforts = [1.0, 0.5, 0.25, 0.5]
    got = []
    for capture in (True, False):
        be = BatchEngine(w, cfg, batch_size=2, pad_to=8, eos_id=-1,
                         kv_dtype=kv_dtype, capture=capture)
        cb = ContinuousBatcher(be)
        out = {}
        for i, (p, e) in enumerate(zip(prompts, efforts)):
            cb.submit(p, 6, e, lambda t, i=i: out.__setitem__(i, t))
        before = dict(LAUNCHES)
        cb.run_until_drained()
        torch.cuda.synchronize()
        got.append((out, {k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
        assert (be._graph is not None) == capture
    assert got[0] == got[1]


@pytest.mark.cuda
def test_program_spans_under_a_trace_on_card(tmp_path):
    """Under trace() on the card the program's spans are logged and in the
    Chrome trace beside the kernels: the scheduler's, and a captured
    turn's session.turn with its launch and read inside."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import os
    from effort_tpu_torch.models.session import ChatSession
    from effort_tpu_torch.serving.batcher import (BatchEngine,
                                                  ContinuousBatcher)
    from effort_tpu_torch.utils import profiling
    cfg, w = _tiny_dense()
    be = BatchEngine(w, cfg, batch_size=2, pad_to=8, eos_id=-1)
    cb = ContinuousBatcher(be)
    sess = ChatSession(w, cfg, pad_to=8, eos_id=-1)
    profiling.clear()
    with profiling.trace(str(tmp_path)):
        for p in ([1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 3]):
            cb.submit(p, 4, 0.5, lambda t: None)
        cb.run_until_drained()
        sess.turn([1, 5, 9], n_new=4, effort=0.5)
    spans = profiling.recorded()
    assert be._graph is not None and len(sess.engine._graphs) == 1
    names = {s.name for s in spans}
    assert {"batcher.tick", "batcher.admit", "batcher.step",
            "batcher.callback", "session.turn", "session.launch",
            "session.read"} <= names
    for s in spans:
        if s.name in ("session.launch", "session.read"):
            assert spans[s.parent].name == "session.turn"
    (f,) = os.listdir(tmp_path)
    with open(tmp_path / f) as fh:
        events = json.load(fh)["traceEvents"]
    notes = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(notes) == sorted(s.name for s in spans
                                   if s.name != "batcher.queued")
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 8, 64])
def test_flash_attention_device_slots_equal_int_slots(T):
    """K3 with start_slot and mask_from as 0-d int32 CUDA tensors (read on
    the card) equals the int call bit for bit (Mistral-7B heads, 32/8/128,
    a 512-slot cache, start slots 0, 37 and 448, a 128-slot window too);
    a captured launch reads new slot values at every replay; a tensor of
    another dtype or device is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.flash_attention import flash_attention_seq
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    S, H, KV, D = 512, 32, 8, 128
    q = torch.randn((T, H * D), generator=g, device="cuda")
    kc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()
    vc = torch.randn((S, KV, D), generator=g, device="cuda").bfloat16()

    def dev(x):
        return torch.full((), x, dtype=torch.int32, device="cuda")
    for start, mask, window in ((0, 0, 0), (37, 5, 0), (448, 0, 0),
                                (448, 0, 128)):
        y = flash_attention_seq(q, kc, vc, start, mask, H, D, window=window)
        yd = flash_attention_seq(q, kc, vc, dev(start), dev(mask), H, D,
                                 window=window)
        torch.cuda.synchronize()
        assert torch.equal(y, yd), (start, mask, window)
    s_buf, m_buf = dev(0), dev(0)
    out = torch.zeros((T, H * D), device="cuda")
    graph = torch.cuda.CUDAGraph()
    flash_attention_seq(q, kc, vc, s_buf, m_buf, H, D)     # warm
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out.copy_(flash_attention_seq(q, kc, vc, s_buf, m_buf, H, D))
    for start, mask in ((37, 5), (448, 0)):
        s_buf.fill_(start)
        m_buf.fill_(mask)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flash_attention_seq(q, kc, vc, start, mask,
                                                    H, D)), start
    before = dict(LAUNCHES)
    for bad in (torch.zeros((), dtype=torch.int64, device="cuda"),
                torch.zeros((), dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32"):
            flash_attention_seq(q, kc, vc, bad, 0, H, D)
    with pytest.raises(ValueError, match="negative"):
        flash_attention_seq(q, kc, vc, -1, 0, H, D)
    assert LAUNCHES == before


@pytest.mark.cuda
def test_engine_captures_the_speculative_round():
    """On the card a speculative round is one replayed graph: graph and
    eager (capture=False) rounds give the same tokens, tokens a round,
    verify logits bit for bit and launches; the round reads no host value
    (set_sync_debug_mode("error")), and the loop reads one status tensor
    a round; the tokens are generate(effort=1.0)'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.models.transformer import HOST_READS
    cfg, w = _tiny_dense()
    prompt = [1, 5, 9, 13]
    eng = Engine(w, cfg, pad_to=8, eos_id=-1)
    eager = Engine(w, cfg, pad_to=8, eos_id=-1, capture=False)
    ref = eng.generate(prompt, n_new=12, effort=1.0).token_ids
    for de, k in ((0.25, 4), (1.0, 3)):
        eng.generate_speculative(prompt, n_new=12, draft_effort=de, k=k)
        runs = []
        for e in (eng, eager):
            before = dict(LAUNCHES)
            HOST_READS["spec_status"] = 0
            st, sp, _ = e._spec_launch(prompt, 12, de, k)
            torch.cuda.synchronize()
            n_gen, done, n_it = sp.status.tolist()
            runs.append((st.ids[4:4 + 12].tolist(), n_it,
                         sp.logits.clone(), HOST_READS["spec_status"],
                         {n: LAUNCHES[n] - before[n] for n in LAUNCHES}))
        (tg, ig, lg, hg, cg), (te, ie, le, he, ce) = runs
        assert tg == te == ref, (de, k)
        assert ig == ie and hg == he == ig, (de, k)
        assert torch.equal(lg, le), (de, k)
        assert cg == ce and cg["flash_attention"] == ig * cfg.n_layers
        graph = eng._graphs[next(key for key in eng._graphs
                                 if key.loop == "spec" and key.spec_k == k)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_batch_engine_captures_the_speculative_step():
    """BatchEngine(spec_k=3)'s step is one replayed graph: the same
    requests give the eager step's tokens and launch counts; K2 runs over
    the B * spec_k rows of the verify."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.serving.batcher import (BatchEngine,
                                                  ContinuousBatcher)
    cfg, w = _tiny_dense()
    prompts = [[1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 3], [2, 9]]
    efforts = [1.0, 0.5, 0.25, 0.5]
    got = []
    for capture in (True, False):
        be = BatchEngine(w, cfg, batch_size=2, pad_to=8, eos_id=-1,
                         spec_k=3, capture=capture)
        cb = ContinuousBatcher(be)
        out = {}
        for i, (p, e) in enumerate(zip(prompts, efforts)):
            cb.submit(p, 6, e, lambda t, i=i: out.__setitem__(i, t))
        before = dict(LAUNCHES)
        cb.run_until_drained()
        torch.cuda.synchronize()
        got.append((out, {k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
        assert (be._graph is not None) == capture
    assert got[0] == got[1]
    assert all(len(t) == 6 for t in got[0][0].values())


@pytest.mark.cuda
def test_captured_turns_equal_eager_on_card():
    """On the card: three turns through captured steps (one graph for
    efforts 0.25 and 0.5) give capture=False's tokens, pos and history."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.models.session import ChatSession
    from effort_tpu_torch.models.transformer import init_random_weights
    cfg = tiny_test_model(max_seq_len=96)
    w = init_random_weights(cfg, BucketConfig(bucket_size=1, chunk_rows=128,
                                              dtype="int8"),
                            fuse=True, device="cuda")
    g = ChatSession(w, cfg, pad_to=4, device="cuda")
    x = ChatSession(w, cfg, pad_to=4, device="cuda", capture=False)
    turns = ([1, 5, 9], [7, 2], [3, 3, 4, 8, 11])
    for turn, e in zip(turns, (0.25, 0.5, 0.25)):
        assert g.turn(turn, n_new=6, effort=e) == x.turn(turn, n_new=6,
                                                          effort=e)
    assert len(g.engine._graphs) == 1
    assert (g.pos, g.history) == (x.pos, x.history)


@pytest.mark.cuda
@pytest.mark.parametrize("args", [
    ["--bucket-size", "1", "--chunk-rows", "128", "--dtype", "int8"], []])
def test_bucket_mode_on_card(capsys, args):
    """`python -m effort_tpu_torch bucket` on the card (K1 at B = 1, K4 at
    the default B = 4): each effort's cos within 1e-3 of the same sweep on
    the kernels' plain versions ("plain" route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch import cli
    from effort_tpu_torch.eval.harness import matrix_quality_sweep
    cli.main(["bucket", *args])
    got = [float(x.split()[-1]) for x in capsys.readouterr().out.splitlines()]
    a = cli.parse_args(["bucket", *args])
    wt, v = cli.bucket_inputs("cuda")
    bm = bucketize(wt, BucketConfig(bucket_size=a.bucket_size,
                                    chunk_rows=a.chunk_rows, dtype=a.dtype),
                   keep_dense=True)
    ref = matrix_quality_sweep(bm, v, impl="plain", wt_dense=wt)
    assert len(got) == len(ref)
    for g, r in zip(got, ref.values()):
        assert abs(g - r) <= 1e-3, (g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [False, True])
def test_train_chunk_reads_no_host_value_on_card(moe):
    """One chunk of the trainer's steps (run_chunk: batches cut on the
    card, loss, backward through the recomputed layers, the clip, the
    schedule and AdamW) under set_sync_debug_mode("error"): no host read;
    finite losses and the step count advanced on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.train import TrainConfig, init_params
    from effort_tpu_torch.train.optim import adamw_init
    from effort_tpu_torch.train.trainer import leaves, run_chunk
    cfg = dataclasses.replace(tiny_test_model(), vocab_size=256, n_layers=2,
                              **(dict(n_experts=4) if moe else {}))
    params = init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    corpus = torch.randint(0, 256, (4096,), generator=g, device="cuda",
                           dtype=torch.int32)
    tcfg = TrainConfig(batch=4, seq_len=64, steps=10, warmup=2,
                       scan_chunk=5, mu_dtype="bfloat16")
    state = adamw_init(leaves(params), tcfg.mu_dtype)
    run_chunk(params, state, cfg, dataclasses.replace(tcfg, scan_chunk=1),
              corpus, 4000, g)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = run_chunk(params, state, cfg, tcfg, corpus, 4000, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert losses.shape == (5,) and bool(torch.isfinite(losses).all())
    assert int(state.count) == 6


@pytest.mark.cuda
def test_tp_ranks_on_one_card_match_single_device():
    """Two tensor-parallel ranks on one card under gloo (spawned, each
    building its own bf16 shard, K1 on the kernel route at tau = 1)
    against the single-device model of the same draws, teacher-forced over
    the same tokens: cos >= 0.999 (the JAX tests' tp bound) at every step,
    and each rank's K1 launches 7 a layer a step, K8 (its local heads) one
    a layer a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.config import tiny_test_model
    from effort_tpu_torch.models.transformer import (forward_token,
                                                     make_kv_cache)
    from effort_tpu_torch.parallel import _ranks, multihost, tp
    cfg = tiny_test_model(dim=512, hidden_dim=1024, n_heads=8, n_kv_heads=4,
                          vocab_size=1024)
    bcfg = BucketConfig(bucket_size=1, chunk_rows=128, dtype="bf16")
    job = dict(mode="tp", n=2, cfg=cfg, bcfg=bcfg, weights=("seed", 0),
               impl="kernel", runs=[dict(effort=1.0, tau=1.0,
                                         tokens=[3, 17, 200, 5], n_new=4)])
    res = multihost.spawn(_ranks.run_jobs, 2, "gloo", "cuda:0", [job],
                          timeout=300)
    run = res[0][0]["runs"][0]
    w, _ = tp.make_tp_weights(cfg, bcfg, 1, 0, rank=0, device="cuda")
    kc, vc = make_kv_cache(cfg, "cuda")
    saved, port_fs._TAU = port_fs._TAU, 1.0
    try:
        ref = [forward_token(w, cfg, t, p, kc, vc, effort=1.0,
                             impl="kernel") for p, t in enumerate(run["fed"])]
    finally:
        port_fs._TAU = saved
    for got, want in zip(run["logits"], ref):
        c = torch.nn.functional.cosine_similarity(
            torch.from_numpy(got).double(), want.double().cpu(), dim=0)
        assert float(c) >= 0.999
    for r in res:
        assert r[0]["runs"][0]["launches"] == {
            "mxu_matvec": 7 * cfg.n_layers * run["steps"],
            "decode_attention": cfg.n_layers * run["steps"]}


# ---- K8: decode attention over the live rows of a bf16 cache ------------

# K8 against the plain version: max|dy| <= K8_TOL max|y_ref|. Both sum in
# f32, in other orders (the kernel by chunks and tiles, then a combine of
# the chunks' partials; the plain version through cuBLAS's GEMV and a
# softmax over every slot); as K3's PV_F32_TOL
K8_TOL = 1e-4


def _k8_inputs(B, S, KV, rep, D, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16)
    q = torch.randn((B, KV * rep * D), generator=g, device="cuda")
    return q, k, v


def _k8_against_plain(q, k, v, pos, mask_from, window):
    """K8 and _attn_core's arithmetic (attn_core on the widened caches,
    the live mask of _live_slots) on the same inputs: slots with a live row
    within K8_TOL, slots with none exactly 0 from K8."""
    from effort_tpu_torch.kernels.decode_attention import (attn_core,
                                                            decode_attention)
    B, S, KV, D = k.shape
    rep = q.shape[1] // (KV * D)
    y = decode_attention(q, k, v, pos, mask_from, window)
    t = torch.arange(S, device="cuda")
    live = (t <= pos[:, None]) & (t >= mask_from[:, None])
    if window:
        live &= t > pos[:, None] - window
    yr = attn_core(q, k.float(), v.float(), live, KV, rep, D)
    torch.cuda.synchronize()
    some = live.any(dim=1)
    assert not y[~some].any()
    if some.any():
        err = float((y[some] - yr[some]).abs().max())
        assert err <= K8_TOL * float(yr[some].abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("KV,rep", [(8, 4), (32, 1), (2, 2)])
@pytest.mark.parametrize("S", [2048, 4096])
@pytest.mark.parametrize("B", [1, 16])
def test_decode_attention_cuda_kernel_matches_plain(B, S, KV, rep, D):
    """K8 against the plain version on the same bf16 caches: positions 0,
    one short of a chunk, at a chunk and S - 1 (one slot a call at B = 1,
    ragged across the slots at B = 16), left pads, a sliding window of a
    chunk and 3, and a slot with no live position; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.decode_attention import decode_plan
    q, k, v = _k8_inputs(B, S, KV, rep, D, seed=B + S + KV + D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    CH = decode_plan(B, KV, rep, S, D, sms).chunk
    edges = [0, CH - 1, CH, S - 1, S // 2 + 3, 2 * CH + 17]
    i32 = dict(dtype=torch.int32, device="cuda")
    if B == 1:
        cases = [(torch.tensor([p], **i32), torch.zeros(1, **i32), 0)
                 for p in edges]
        cases += [(torch.tensor([300], **i32), torch.tensor([5], **i32), 0),
                  (torch.tensor([S - 1], **i32), torch.zeros(1, **i32),
                   CH + 3),
                  (torch.tensor([40], **i32), torch.tensor([41], **i32), 0)]
    else:
        g = torch.Generator(device="cuda")
        g.manual_seed(7)
        pos = torch.randint(0, S, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
        pos[:len(edges)] = torch.tensor(edges, **i32)
        offs = torch.randint(0, 40, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        offs[0] = 0
        offs[B - 1] = pos[B - 1] + 1                 # no live position
        cases = [(pos, torch.zeros(B, **i32), 0), (pos, offs, 0),
                 (pos, offs, CH + 3)]
    launches = LAUNCHES["decode_attention"]
    for pos, mf, window in cases:
        _k8_against_plain(q, k, v, pos, mf, window)
    assert LAUNCHES["decode_attention"] == launches + len(cases)


@pytest.mark.cuda
def test_decode_attention_under_a_captured_graph_equals_eager():
    """K8 captured once, replayed as the positions and left pads in its
    buffers move (the kernel reads them on the card): each replay equals
    the eager call at the same positions, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.decode_attention import decode_attention
    B, S = 4, 2048
    q, k, v = _k8_inputs(B, S, 8, 4, 128, seed=11)
    pos = torch.tensor([5, 700, 1500, 2047], dtype=torch.int32,
                       device="cuda")
    offs = torch.tensor([0, 3, 0, 9], dtype=torch.int32, device="cuda")
    out = torch.empty((B, q.shape[1]), device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(decode_attention(q, k, v, pos, offs))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(decode_attention(q, k, v, pos, offs))
    for step in range(4):
        pos.copy_(torch.tensor([5 + 300 * step, 700 - step, 1500 + step,
                                2047 - 500 * step], dtype=torch.int32))
        offs.copy_(torch.tensor([step, 3, 0, 9 + step], dtype=torch.int32))
        graph.replay()
        want = decode_attention(q, k, v, pos, offs)
        torch.cuda.synchronize()
        assert torch.equal(out, want), step


@pytest.mark.cuda
def test_decode_attention_on_two_streams_at_once_equals_one_stream():
    """Launches enqueued in turn on two streams, which may run at once,
    each combine their own chunks (a stream's own tickets): every output
    equals the same call's on the default stream, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.decode_attention import decode_attention
    calls = []
    for i in range(8):
        q, k, v = _k8_inputs(1 + i % 2, 2048, 8, 4, 128, seed=20 + i)
        pos = torch.full((q.shape[0],), 1024 + 100 * i, dtype=torch.int32,
                         device="cuda")
        calls.append((q, k, v, pos, pos * 0))
    want = [decode_attention(*c) for c in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(4):
        for i, c in enumerate(calls):
            with torch.cuda.stream(streams[i % 2]):
                got.append(decode_attention(*c))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for j, y in enumerate(got):
        assert torch.equal(y, want[j % len(calls)]), j


@pytest.mark.cuda
def test_decode_attention_wrapper_raises_on_what_it_does_not_take():
    """On CUDA tensors K8's wrapper launches or raises: f32 caches, caches
    on the CPU, heads 264 or 12 wide, 65 query heads to a KV head, int64
    or wrongly sized positions and an int position for several slots are
    refused before any launch, and nothing is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.decode_attention import decode_attention
    q, k, v = _k8_inputs(2, 64, 2, 2, 64, seed=3)
    pos = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="bf16"):
        decode_attention(q, k.float(), v.float(), pos, pos * 0)
    with pytest.raises(ValueError, match="tensors on"):
        decode_attention(q, k.cpu(), v.cpu(), pos, pos * 0)
    for D in (264, 12):
        qd, kd, vd = _k8_inputs(2, 64, 2, 2, D, seed=4)
        with pytest.raises(ValueError, match="from 8 to 256"):
            decode_attention(qd, kd, vd, pos, pos * 0)
    qr, kr, vr = _k8_inputs(2, 64, 1, 65, 64, seed=5)
    with pytest.raises(ValueError, match="rep 65"):
        decode_attention(qr, kr, vr, pos, pos * 0)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, pos.long(), pos * 0)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, pos[:1], pos * 0)
    with pytest.raises(ValueError, match="int32 tensor"):
        decode_attention(q, k, v, 3, 0)
    assert LAUNCHES == before


@pytest.mark.cuda
def test_decode_attention_launches_once_a_layer_a_step():
    """LAUNCHES["decode_attention"] rises by n_layers a step: Engine's
    captured decode steps, a captured chat turn, and BatchEngine's captured
    step (its admissions run K3, not K8); the int8 cache's steps take the
    plain version and launch none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.models.session import ChatSession
    from effort_tpu_torch.models.transformer import k8_route
    from effort_tpu_torch.serving.batcher import (BatchEngine,
                                                  ContinuousBatcher)
    cfg, w = _tiny_dense()
    L = cfg.n_layers
    prompt = [1, 5, 9, 13]
    for kw, per_step in (({}, L), ({"quant_kv": True}, 0)):
        eng = Engine(w, cfg, pad_to=8, eos_id=-1, **kw)
        eng.generate(prompt, n_new=3, effort=0.5)           # capture
        before = LAUNCHES["decode_attention"]
        eng.generate(prompt, n_new=6, effort=0.5)
        steps = 8 + 6 - 1
        assert LAUNCHES["decode_attention"] - before == per_step * steps, kw
    sess = ChatSession(w, cfg, pad_to=4, eos_id=-1)
    assert k8_route(sess.device, sess.k_cache.dtype, cfg)
    sess.turn([1, 5, 9], n_new=2, effort=0.5)               # capture
    before = LAUNCHES["decode_attention"]
    sess.turn([7, 2], n_new=5, effort=0.5)
    assert LAUNCHES["decode_attention"] - before == L * (2 + 5)
    be = BatchEngine(w, cfg, batch_size=2, pad_to=8, eos_id=-1)
    assert be.capture and k8_route(be.device, be.k_cache.dtype, cfg)
    cb = ContinuousBatcher(be)
    for p in ([1, 5, 9], [4, 8, 15, 16, 23], [7, 7, 3]):
        cb.submit(p, 4, 0.5, lambda t: None)
    before = LAUNCHES["decode_attention"]
    cb.run_until_drained()
    assert be._graph is not None
    assert LAUNCHES["decode_attention"] - before == L * cb.counts["steps"]


# ---- K9: latent attention of an MLA model in absorbed form --------------

# K9 against the plain version: max|dy| <= K9_TOL max|y_ref|. Both sum in
# f32, in other orders (the kernel by 16-row tiles and chunks, then a
# combine of the chunks' partials; the plain version through einsums over
# every row and a softmax over all of them); as K8_TOL
K9_TOL = 1e-4


def _k9_inputs(B, S, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((B, 16, 576), generator=g, device="cuda")
    cache = torch.randn((B, S, 576), generator=g, device="cuda").to(
        torch.bfloat16)
    return q, cache


def _k9_against_plain(q, cache, pos, mask_from):
    """K9 and its plain version on the same inputs: slots with a live row
    within K9_TOL, slots with none exactly 0 from K9."""
    from effort_tpu_torch.kernels.mla_decode import (mla_decode,
                                                     mla_decode_ref)
    y = mla_decode(q, cache, pos, mask_from, 0.11472)
    yr = mla_decode_ref(q, cache, pos, mask_from, 0.11472)
    torch.cuda.synchronize()
    some = (pos >= mask_from) & (mask_from < cache.shape[1])
    assert not y[~some].any()
    if some.any():
        err = float((y[some] - yr[some]).abs().max())
        assert err <= K9_TOL * float(yr[some].abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1024, 4096])
@pytest.mark.parametrize("B", [1, 3])
def test_mla_decode_cuda_kernel_matches_plain(B, S):
    """K9 against its plain version at DeepSeek-V2's widths over caches of
    1k and 4k rows: positions 0, a tile's last and next row, a chunk's
    edges, the middle and S - 1, left pads, and a slot with no live
    position (ragged across the slots at B = 3); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.mla_decode import mla_plan
    q, cache = _k9_inputs(B, S, seed=B + S)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = mla_plan(S, sms)
    ch = 16 * plan.min_tiles
    edges = [0, 15, 16, ch - 1, ch, S // 2 + 3, S - 1]
    i32 = dict(dtype=torch.int32, device="cuda")
    cases = []
    for p in edges:
        pos = torch.tensor([p, S - 1 - p, p // 2][:B], **i32)
        cases.append((pos, torch.zeros(B, **i32)))
    cases += [(torch.tensor([300, 1000, 17][:B], **i32),
               torch.tensor([5, 999, 0][:B], **i32)),
              (torch.tensor([40, S - 1, 3][:B], **i32),
               torch.tensor([41, 0, 4][:B], **i32))]
    launches = LAUNCHES["mla_decode"]
    for pos, mf in cases:
        _k9_against_plain(q, cache, pos, mf)
    assert LAUNCHES["mla_decode"] == launches + len(cases)


@pytest.mark.cuda
def test_mla_decode_under_a_captured_graph_equals_eager():
    """K9 captured once, replayed as the position and left pad in its
    buffers move (the kernel reads them on the card and chunks the live
    range itself): each replay equals the eager call, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.mla_decode import mla_decode
    q, cache = _k9_inputs(1, 4096, seed=5)
    pos = torch.tensor([5], dtype=torch.int32, device="cuda")
    mf = torch.tensor([0], dtype=torch.int32, device="cuda")
    out = torch.empty((1, 16, 512), device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(mla_decode(q, cache, pos, mf, 0.1))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(mla_decode(q, cache, pos, mf, 0.1))
    for p, m in ((5, 0), (4095, 0), (1000, 7), (16, 16), (2047, 2000)):
        pos.fill_(p)
        mf.fill_(m)
        graph.replay()
        want = mla_decode(q, cache, pos, mf, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(out, want), p


@pytest.mark.cuda
def test_mla_decode_wrapper_raises_on_what_it_does_not_take():
    """On CUDA tensors K9's wrapper launches or raises: an f32 cache, a
    cache on the CPU, 8 heads, rows 512 wide, int64 positions and an int
    position for several slots are refused before any launch, and nothing
    is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.kernels.mla_decode import mla_decode
    q, cache = _k9_inputs(2, 64, seed=3)
    pos = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="bf16"):
        mla_decode(q, cache.float(), pos, pos * 0)
    with pytest.raises(ValueError, match="tensors on"):
        mla_decode(q, cache.cpu(), pos, pos * 0)
    with pytest.raises(ValueError, match="16 heads"):
        mla_decode(q[:, :8].contiguous(), cache, pos, pos * 0)
    with pytest.raises(ValueError, match="16 heads"):
        mla_decode(q[..., :512].contiguous(), cache[..., :512].contiguous(),
                   pos, pos * 0)
    with pytest.raises(ValueError, match="int32"):
        mla_decode(q, cache, pos.long(), pos * 0)
    with pytest.raises(ValueError, match="int32 tensor"):
        mla_decode(q, cache, 3, 0)
    assert LAUNCHES == before


def _small_deepseek():
    """DeepSeek-V2-Lite's attention widths (K9's) at 3 layers, 8 experts
    of 256 (top 2) and one shared, hidden 512, int8 row-prefix buckets,
    from the test reference's seeded raw weights."""
    from deepseek_v2_reference import raw_weights
    from effort_tpu_torch.config import deepseek_v2_lite
    from effort_tpu_torch.models import transformer as tf
    cfg = deepseek_v2_lite(dim=512, hidden_dim=1024, n_layers=3,
                           n_experts=8, n_experts_per_tok=2,
                           moe_hidden_dim=256, n_shared_experts=1,
                           vocab_size=1024, max_seq_len=256)
    hf = dict(num_hidden_layers=3, hidden_size=512, intermediate_size=1024,
              num_attention_heads=16, kv_lora_rank=512, qk_nope_head_dim=128,
              qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=8,
              num_experts_per_tok=2, moe_intermediate_size=256,
              n_shared_experts=1, first_k_dense_replace=1, vocab_size=1024)
    raw = raw_weights(hf, seed=3, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(4)

    def rms(n):
        return torch.exp(torch.randn(n, generator=g, device="cuda") * 1.2)
    w = tf.quantize_head(tf.assemble_weights(
        raw, cfg, BucketConfig(bucket_size=1, chunk_rows=128, dtype="int8"),
        rms_m=rms(512), rms_f=rms(1024), rms_e=rms(256), rms_s=rms(256)))
    return cfg, w


@pytest.mark.cuda
def test_mla_decode_launches_once_a_layer_a_step():
    """An MLA model on the card: LAUNCHES["mla_decode"] rises by n_layers
    a step through Engine's captured decode steps and a captured chat
    turn, and no K8 runs; the captured turn's tokens equal the eager
    turn's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.models.session import ChatSession
    cfg, w = _small_deepseek()
    L = cfg.n_layers
    prompt = [1, 5, 9, 13]
    eng = Engine(w, cfg, pad_to=8, eos_id=-1)
    eng.generate(prompt, n_new=3, effort=0.25)               # capture
    before = dict(LAUNCHES)
    eng.generate(prompt, n_new=6, effort=0.25)
    steps = 8 + 6 - 1
    assert LAUNCHES["mla_decode"] - before["mla_decode"] == L * steps
    assert LAUNCHES["decode_attention"] == before["decode_attention"]
    turns = []
    for capture in (True, False):
        sess = ChatSession(w, cfg, pad_to=4, eos_id=-1, capture=capture)
        assert sess.k_cache.is_cuda
        out = [sess.turn([1, 5, 9], n_new=2, effort=0.25)]
        before = LAUNCHES["mla_decode"]
        out.append(sess.turn([7, 2], n_new=5, effort=0.25))
        assert LAUNCHES["mla_decode"] - before == L * (2 + 5)
        turns.append(out)
    assert turns[0] == turns[1]


@pytest.mark.cuda
def test_mla_model_at_widths_k9_does_not_take_raises_on_the_card():
    """An MLA model whose attention widths K9 does not take (the tiny
    shape of tests/test_torch_deepseek.py: 4 heads over 80-wide rows) runs
    no plain attention on the card: its decode step raises K9's refusal,
    and nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepseek_v2_reference import raw_weights
    from effort_tpu_torch.config import deepseek_v2_lite
    from effort_tpu_torch.models import transformer as tf
    from effort_tpu_torch.models.session import ChatSession
    cfg = deepseek_v2_lite(dim=128, hidden_dim=256, n_layers=2, n_heads=4,
                           n_kv_heads=4, head_dim=32, n_experts=4,
                           n_experts_per_tok=2, moe_hidden_dim=64,
                           n_shared_experts=1, kv_lora_rank=64,
                           qk_nope_head_dim=32, qk_rope_head_dim=16,
                           v_head_dim=32, vocab_size=256, max_seq_len=64)
    hf = dict(num_hidden_layers=2, hidden_size=128, intermediate_size=256,
              num_attention_heads=4, kv_lora_rank=64, qk_nope_head_dim=32,
              qk_rope_head_dim=16, v_head_dim=32, n_routed_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=64,
              n_shared_experts=1, first_k_dense_replace=1, vocab_size=256)
    w = tf.assemble_weights(raw_weights(hf, seed=1, device="cuda"), cfg,
                            BucketConfig(bucket_size=1, chunk_rows=16,
                                         dtype="int8"))
    sess = ChatSession(w, cfg, pad_to=4, eos_id=-1, capture=False)
    before = LAUNCHES["mla_decode"]
    with pytest.raises(ValueError, match="16 heads"):
        sess.turn([1, 5, 9], n_new=2, effort=1.0)
    assert LAUNCHES["mla_decode"] == before
