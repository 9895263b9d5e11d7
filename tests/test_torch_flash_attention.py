"""Prefill flash attention (kernel K3) of the port against the JAX package's
flash_attention_seq run in Pallas interpret mode, on the same numpy inputs:
the cases of tests/test_flash_attention.py and the sliding-window case of
tests/test_sliding_window.py, plus left-padded prompts whose pad queries
see no key.

On the CPU the port's wrapper runs the kernel's plain version
(flash_attention_ref); the CUDA kernel itself is held against that plain
version on the card by tests/test_torch_cuda.py and by chip_smoke.py.

Tolerance: both sides round Q to bf16 and read bf16 K and V, so every
product is exact in f32; they differ in the order of the f32 sums and in
the online softmax's rescaling (JAX) against one max (the plain version),
a few units in the last place. Held at rtol 1e-4, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effort_tpu.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from effort_tpu.kernels.flash_attention import \
    flash_attention_seq as jax_flash_attention_seq
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels.flash_attention import (flash_attention,
                                                      flash_attention_seq,
                                                      flash_limits,
                                                      flash_plan)
from test_torch_bridge import cos

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _bf16(rng, shape):
    """Random bf16 values as (JAX array, torch tensor) with equal bits."""
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16), t


def _case(seed, T, S, H, KV, D, filled=None, q_scale=1.0):
    """Q2 [T, H*D] f32 and bf16 caches [S, KV, D]; filled = (lo, hi) keeps
    only cache rows lo..hi-1 non-zero, as tests/test_flash_attention.py
    fills them."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((T, H * D)) * q_scale).astype(np.float32)
    kj, kt = _bf16(rng, (S, KV, D))
    vj, vt = _bf16(rng, (S, KV, D))
    if filled is not None:
        lo, hi = filled
        keep = np.zeros((S, 1, 1), bool)
        keep[lo:hi] = True
        kj, vj = jnp.where(keep, kj, 0), jnp.where(keep, vj, 0)
        m = torch.from_numpy(keep)
        kt, vt = torch.where(m, kt, 0), torch.where(m, vt, 0)
    return q, (kj, vj), (kt, vt)


def _both(q, jkv, tkv, start, mask_from, H, D, window=0, pv_f32=True,
          **jax_kw):
    yj = np.asarray(jax_flash_attention_seq(
        jnp.asarray(q), *jkv, start, mask_from, H, D, window=window,
        interpret=True, pv_f32=pv_f32, **jax_kw))
    yt = flash_attention_seq(torch.from_numpy(q), *tkv, start, mask_from,
                             H, D, window=window, pv_f32=pv_f32)
    return yj, yt.numpy()


@pytest.mark.parametrize("T,S,offset", [(16, 32, 0), (16, 32, 5),
                                        (8, 64, 3)])
def test_flash_matches_jax(T, S, offset):
    """tests/test_flash_attention.py::test_flash_matches_reference: the
    queries at slots offset.., the cache filled there."""
    q, jkv, tkv = _case(0, T, S, 4, 2, 128, filled=(offset, offset + T))
    yj, yt = _both(q, jkv, tkv, offset, offset, 4, 128)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)


def test_flash_many_blocks_matches_jax():
    """tests/test_flash_attention.py::test_flash_block_sizes: queries near
    the end of a 256-slot cache, several KV blocks."""
    q, jkv, tkv = _case(7, 32, 256, 2, 2, 128, q_scale=2.0)
    yj, yt = _both(q, jkv, tkv, 100, 0, 2, 128)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pv_f32", [True, False])
def test_flash_at_scale_matches_jax(pv_f32):
    """tests/test_flash_attention.py::test_flash_error_bounded_at_scale's
    shape (T 512 over S 2048, H 8, KV 2). With pv_f32=False both round the
    probabilities to bf16 before P@V, JAX against each block's running
    max and the plain version against the row's final max, so they agree
    to bf16 rounding only: cos >= 0.9999 there."""
    q, jkv, tkv = _case(1, 512, 2048, 8, 2, 128)
    yj, yt = _both(q, jkv, tkv, 2048 - 512, 0, 8, 128, pv_f32=pv_f32)
    if pv_f32:
        np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)
    else:
        assert cos(yt.ravel(), yj.ravel()) >= 0.9999


def test_flash_window_matches_jax():
    """tests/test_sliding_window.py:71: a 24-slot window over 64 queries;
    the window changes the answer."""
    q, jkv, tkv = _case(2, 64, 64, 4, 2, 128)
    yj, yt = _both(q, jkv, tkv, 0, 0, 4, 128, window=24, block_q=16,
                   block_k=16)
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)
    full = flash_attention_seq(torch.from_numpy(q), *tkv, 0, 0, 4, 128)
    assert not np.allclose(full.numpy(), yt, atol=1e-3)


@pytest.mark.parametrize("pad", [5, 27])
def test_left_padded_prompt_pad_rows_are_zero(pad):
    """A left-padded prompt (start_slot 0, mask_from = pad): the pad
    queries see no key and give exactly 0, as JAX's kernel does; the real
    queries match JAX."""
    q, jkv, tkv = _case(3, 32, 64, 4, 2, 64)
    yj, yt = _both(q, jkv, tkv, 0, pad, 4, 64)
    assert not np.abs(yt[:pad]).any() and not np.abs(yj[:pad]).any()
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)


def test_flash_attention_layout_matches_jax():
    """The public flash_attention in JAX's layout, Q [KV, rep, T, D] and
    K/V [KV, S, D], at a start slot past 0; CPU tensors count no launch."""
    rng = np.random.default_rng(4)
    KV, rep, T, D, S = 2, 3, 16, 64, 48
    qj, qt = _bf16(rng, (KV, rep, T, D))
    kj, kt = _bf16(rng, (KV, S, D))
    vj, vt = _bf16(rng, (KV, S, D))
    launches = LAUNCHES["flash_attention"]
    yj = np.asarray(jax_flash_attention(qj, kj, vj, 20, 4, block_q=16,
                                        block_k=16, interpret=True))
    yt = flash_attention(qt, kt, vt, 20, 4).numpy()
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)
    assert LAUNCHES["flash_attention"] == launches


def test_flash_plan_fills_the_card_at_prefill():
    """At T = 64 with Mistral-7B's GQA (rep 4, KV 8) the plan puts at
    least 128 blocks on a 132-SM card, one row warp with four key warps
    each; at T = 512 it takes four row warps with two key warps a block,
    and still more blocks than SMs."""
    p = flash_plan(64, 4, 8, 132)
    assert p.blocks >= 128 and (p.rw, p.kw) == (1, 4)
    p = flash_plan(512, 4, 8, 132)
    assert (p.rw, p.kw) == (4, 2) and p.blocks >= 132


@pytest.mark.parametrize("T", [1, 17, 64, 512])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_flash_plan_covers_every_row_once(T, rep):
    """The kernel's rows (block (qb, kv), row r < 16 * rw: query head r //
    bq, query qb * bq + r % bq, live where r < rep * bq and the query < T)
    cover every (KV head, query head, query) once, in at most 8 warps a
    block, with 2 or 4 key warps (the kernel takes no other)."""
    KV = 2
    p = flash_plan(T, rep, KV, 132)
    assert p.rw * p.kw <= 8 and p.kw in (2, 4) and rep * p.bq <= 16 * p.rw
    seen = {}
    for kv in range(p.kv):
        for qb in range(p.q_blocks):
            for r in range(16 * p.rw):
                t = qb * p.bq + r % p.bq
                if r < rep * p.bq and t < T:
                    key = (kv, r // p.bq, t)
                    seen[key] = seen.get(key, 0) + 1
    assert len(seen) == KV * rep * T and set(seen.values()) == {1}


@pytest.mark.parametrize("D,ok", [(72, True), (256, True), (8, True),
                                  (12, False), (264, False), (0, False)])
def test_flash_kernel_head_limits(D, ok):
    """The kernel takes heads of any multiple of 8 up to 256 wide (a depth
    that is not a multiple of 16 is zero-padded); the wrapper refuses the
    rest with the limit in the message."""
    why = flash_limits(D)
    assert (why is None) == ok
    if not ok:
        assert "from 8 to 256" in why


def test_flash_256_wide_heads_match_jax():
    """Heads 256 wide (JAX's flash takes any D): the plain version against
    JAX's kernel in interpret mode over a left-padded prompt."""
    q, jkv, tkv = _case(5, 24, 48, 4, 2, 256)
    yj, yt = _both(q, jkv, tkv, 0, 3, 4, 256)
    assert not np.abs(yt[:3]).any()
    np.testing.assert_allclose(yt, yj, rtol=RTOL, atol=ATOL)
