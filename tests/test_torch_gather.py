"""The block gather (bucket_size >= 2) of the port against the JAX
package: select_blocks, and the plain versions of K6 (gather_matvec_dma,
packed positions) and K7 (gather_bucket_matvec, one position byte a
column) against the JAX kernels run in Pallas interpret mode on one
selection; the plain versions' pad skipping and split count (the kernels'
launch plan, gather_plan).

JAX's gather_bucket_matvec takes an interpret flag; its gather_matvec_dma
has none, so that test patches jax.experimental.pallas.pallas_call to pass
interpret=True (the JAX package itself is unchanged).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from effort_tpu.kernels.gather_dma import gather_matvec_dma as jax_k6
from effort_tpu.kernels.gather_mul import gather_bucket_matvec as jax_k7
from effort_tpu.ops.effort import select_blocks as jax_select_blocks
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import gather_dma, gather_mul
from effort_tpu_torch.kernels import prefix_stream as port_ps
from effort_tpu_torch.ops.bucketmul import bucket_matvec, gather_capacity
from effort_tpu_torch.ops.effort import BlockSelection, select_blocks
from test_torch_rank_prefix import EFFORT, assert_close, containers

torch.set_num_threads(2)


def selections(jb, tb, v, effort, max_blocks):
    sj = jax_select_blocks(jb, jnp.asarray(v), effort, 0, max_blocks)
    st = select_blocks(tb, torch.from_numpy(v), effort, 0, max_blocks)
    return sj, st


@pytest.mark.parametrize("dtype,percent_load", [("bf16", 1.0),
                                                ("int8", 1.0),
                                                ("int4", 1.0),
                                                ("int8", 0.5)])
@pytest.mark.parametrize("capacity", ["route", "tight"])
def test_select_blocks_matches_jax(dtype, percent_load, capacity):
    """block_ids and n_blocks equal JAX's, u_scaled within 1e-6 relative,
    at the gather route's capacity and at one that overflows (the deepest
    ranks dropped first, n_blocks still the uncapped count)."""
    jb, tb, v = containers(dtype, seed=6, percent_load=percent_load)
    for e in (0.25, EFFORT):
        cap = gather_capacity(tb, e) if capacity == "route" else 8
        sj, st = selections(jb, tb, v, e, cap)
        np.testing.assert_array_equal(st.block_ids.numpy(),
                                      np.asarray(sj.block_ids))
        assert int(st.n_blocks) == int(sj.n_blocks)
        np.testing.assert_allclose(st.u_scaled.numpy(),
                                   np.asarray(sj.u_scaled), rtol=1e-6,
                                   atol=0)
        ids = st.block_ids.numpy()
        real = ids[ids != tb.zero_block_id]
        assert (np.diff(real) > 0).all()            # ascending
        assert len(real) == min(int(st.n_blocks), cap)
        if capacity == "tight":
            assert int(st.n_blocks) > cap


def test_gather_capacity_rule():
    """max_blocks = min(round_up(max(8, int(blocks * min(1, 2.6 effort +
    0.05))), 8), round_up(blocks, 8)), as the JAX package's gather route
    sizes it."""
    _, tb, _ = containers("int8")
    blocks = tb.blocks_per_expert                 # 4 ranks x 16 chunks
    assert gather_capacity(tb, 0.1) == 24         # int(64 * 0.31) = 19
    assert gather_capacity(tb, 0.0) == 8
    assert gather_capacity(tb, 1.0) == blocks
    assert gather_capacity(tb, 0.25) == 48        # int(64 * 0.7) = 44


@pytest.fixture
def dma_interpret(monkeypatch):
    call = jax_pallas.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return call(*args, **kw)
    monkeypatch.setattr(jax_pallas, "pallas_call", interpreted)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gather_matvec_dma_plain_matches_jax_interpret(dma_interpret, dtype):
    """K6's plain version against JAX's gather_matvec_dma in interpret mode
    on JAX's selection carried across: cos >= 0.99999, max|dy| <= 1e-5
    max|y_ref|; no launch counted on the CPU."""
    jb, tb, v = containers(dtype, seed=7)
    sj, _ = selections(jb, tb, v, EFFORT, gather_capacity(tb, EFFORT))
    yj = jax_k6(jb, sj)
    st = BlockSelection(*(torch.from_numpy(np.array(a)) for a in sj))
    before = dict(LAUNCHES)
    assert_close(yj, gather_dma.gather_matvec_dma(tb, st))
    assert LAUNCHES == before


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_gather_bucket_matvec_plain_matches_jax_interpret(dtype):
    """K7's plain version against JAX's gather_bucket_matvec in interpret
    mode, at a capacity that drops blocks too: cos >= 0.99999, max|dy| <=
    1e-5 max|y_ref|; with the positions given or unpacked in the call, and
    equal to K6's plain version."""
    jb, tb, v = containers(dtype, seed=8)
    for cap in (gather_capacity(tb, EFFORT), 16):
        sj, st = selections(jb, tb, v, EFFORT, cap)
        yj = jax_k7(jb, sj, interpret=True)
        y7 = gather_mul.gather_bucket_matvec(tb, st)
        assert_close(yj, y7)
        torch.testing.assert_close(
            gather_mul.gather_bucket_matvec(
                tb, st, gather_mul.unpacked_positions(tb)), y7,
            rtol=0, atol=0)
        torch.testing.assert_close(gather_dma.gather_matvec_dma(tb, st), y7,
                                   rtol=1e-6, atol=1e-7)


def test_gather_refuses_int4():
    """int4-packed values: both gathers raise (JAX's gather_matvec_dma
    asserts the same), on the plain version and through the route."""
    _, tb, v = containers("int4", seed=9)
    st = select_blocks(tb, torch.from_numpy(v), EFFORT, 0, 32)
    with pytest.raises(ValueError, match="int4"):
        gather_dma.gather_matvec_dma(tb, st)
    with pytest.raises(ValueError, match="int4"):
        gather_mul.gather_bucket_matvec(tb, st)
    with pytest.raises(ValueError, match="int4"):
        bucket_matvec(tb, torch.from_numpy(v), EFFORT, impl="gather")


@pytest.mark.parametrize("name,in_dim,out_dim,col_blocks", [
    ("wqkv", 4096, 6144, 3), ("wo", 4096, 4096, 2), ("w13", 4096, 28672, 14),
    ("w2", 14336, 4096, 2)])
def test_gather_plan_at_mistral_widths(name, in_dim, out_dim, col_blocks):
    """The ring gather's launch shape at the four Mistral-7B projections
    (B = 4, G = 16; the container's widths stood in on a small one): a
    producer warp beside four consumer warps, column blocks that cover the
    position row (packed for K6, one byte a column for K7: the same count
    here), and splits that keep every block resident (at most _RING_BLOCKS
    in all), at most one an id, the same for K6 and K7."""
    import dataclasses
    _, tb, _ = containers("int8")
    B = tb.bucket_size
    prow = -(-(out_dim // B) * 2 // 8 // 128) * 128   # 2-bit positions
    bm = dataclasses.replace(
        tb, in_dim=in_dim, out_dim=out_dim,
        pos=torch.zeros((1, 1, prow), dtype=torch.uint8))
    for n_ids in (1, 40, 720, 2512):
        threads, cb, splits = port_ps.gather_plan(bm, n_ids, prow)
        t7, cb7, s7 = port_ps.gather_plan(bm, n_ids, out_dim // B,
                                          packed=False)
        assert threads == t7 == 32 * 5
        assert cb == cb7 == col_blocks
        assert cb * 32 * port_ps.cols_per_thread(B, True) >= prow
        assert s7 == splits == max(1, min(n_ids,
                                          port_ps._RING_BLOCKS // cb))
        assert cb * splits <= port_ps._RING_BLOCKS


@pytest.mark.parametrize("capacity", ["above", "at", "below"])
@pytest.mark.parametrize("G,B,dtype", [(G, B, d) for G in (8, 16)
                                       for B in (2, 4)
                                       for d in ("bf16", "int8")])
def test_plain_gather_skips_pads_bit_for_bit(dma_interpret, G, B, dtype,
                                             capacity):
    """K6's and K7's plain versions (the kernels' order of sums) at G 8 and
    16, B 2 and 4, bf16 and int8, with the capacity above the real block
    count (pads after the real ids), at it, and below it (blocks dropped):
    they walk only the real ids, and give the same bits as the sum over the
    whole id list, pads included, in gather_plan's splits (a pad adds
    +-0 to sums that are never -0); K7's equals K6's; both are within cos
    0.99999 and 1e-5 max|y_ref| of JAX's gather_matvec_dma (interpret
    mode) and gather_bucket_matvec (interpret=True) on JAX's selection
    carried across; no launch is counted on the CPU."""
    jb, tb, v = containers(dtype, seed=G + B, B=B, chunk_rows=G)
    K, nc = tb.n_ranks, tb.n_chunks
    need = int(select_blocks(tb, torch.from_numpy(v), EFFORT, 0,
                             tb.blocks_per_expert).n_blocks)
    assert 8 < need
    cap = {"above": need + 8, "at": need, "below": need - 8}[capacity]
    sj, st = selections(jb, tb, v, EFFORT, cap)
    assert int(st.n_blocks) == need
    pos7 = gather_mul.unpacked_positions(tb)
    before = dict(LAUNCHES)
    ids = st.block_ids.long()
    ys = []
    for pos in (None, pos7):
        splits = port_ps.gather_plan(
            tb, cap, (tb.pos if pos is None else pos).shape[2],
            pos is None)[2]
        assert 1 <= splits <= cap
        whole = port_ps.split_sum(tb, ids * G,
                                  st.u_scaled[(ids // nc) % K, ids % nc],
                                  splits, pos)
        ys.append(gather_dma.gather_product_ref(tb, st, pos))
        assert torch.equal(ys[-1], whole)
    assert torch.equal(ys[1], ys[0])
    assert torch.equal(gather_dma.gather_matvec_dma(tb, st), ys[0])
    assert torch.equal(gather_mul.gather_bucket_matvec(tb, st, pos7), ys[0])
    stj = BlockSelection(*(torch.from_numpy(np.array(a)) for a in sj))
    assert_close(jax_k6(jb, sj), gather_dma.gather_matvec_dma(tb, stj))
    assert_close(jax_k7(jb, sj, interpret=True),
                 gather_mul.gather_bucket_matvec(tb, stj))
    assert LAUNCHES == before
