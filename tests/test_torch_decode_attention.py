"""K8, the port's decode attention over the live rows of a bf16 cache
(kernels/decode_attention.py), on the CPU: its route, its plan, its plain
version, a mirror of the kernel's chunked algorithm, and the counts of the
rows it reads that BatchEngine and ChatSession state.

The kernel itself runs only on the card (tests/test_torch_cuda.py). Here:
  - CPU tensors keep the plain path: _attention and forward_token_batch
    give what the unchanged plain arithmetic gives, bit for bit, and never
    reach the kernel's wrapper;
  - k8_route picks K8 only for bf16 caches on the card with heads the
    kernel takes;
  - decode_plan's chunks adapt to (B, KV, S) and cover the cache;
  - _mirror replays the kernel's blocking in float64 (chunks of whole
    tiles, blocks outside the live range skipped, each warp's rows of a
    tile under its own online softmax, the warps merged, partials combined
    in chunk order): it equals the plain version to 1e-12 at every case
    the card tests take, and its warps cover every row of a tile once, so
    the index arithmetic the CUDA source shares with it is right;
  - BatchEngine.positions and ChatSession._turn_attrs state the rows K8
    reads: every slot's live range, left pads, spec_k drafts and positions
    near the end of the cache, through transformer.attention_reads, which
    follows the route and K8's head groups.
Tolerances: exact where the same arithmetic runs; the mirror, in float64
against the float64 plain version, to 1e-12.
"""

import dataclasses
import math

import pytest
import torch

from effort_tpu_torch.config import BucketConfig, tiny_test_model
from effort_tpu_torch.kernels import LAUNCHES
from effort_tpu_torch.kernels import decode_attention as k8
from effort_tpu_torch.models import transformer as tf
from effort_tpu_torch.models.session import ChatSession, live_positions
from effort_tpu_torch.serving.batcher import BatchEngine

torch.set_num_threads(2)

CUDA = torch.device("cuda")


def _parent_attn_core(q, kf, vf, live, cfg):
    """The plain decode attention as the port had it before K8, verbatim."""
    KV, rep, D = cfg.n_kv_heads, cfg.kv_repeats, cfg.head_dim
    lead = q.shape[:-1]
    qh = q.reshape(*lead, KV, rep, D).to(torch.float32)
    scores = torch.einsum("...krd,...tkd->...krt", qh, kf) / math.sqrt(D)
    scores = torch.where(live[..., None, None, :], scores,
                         torch.full_like(scores, -math.inf))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("...krt,...tkd->...krd", probs, vf)
    return out.reshape(*lead, cfg.n_heads * D)


def _caches(B, S, KV, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    k = torch.randn((B, S, KV, D), generator=g).to(torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=g).to(torch.bfloat16)
    return k, v


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("pos,mask_from", [(0, 0), (7, 0), (19, 3),
                                           (31, 0)])
def test_attention_on_cpu_is_the_parents_plain_path(window, pos, mask_from,
                                                    monkeypatch):
    """_attention on CPU tensors: the parent's plain arithmetic bit for bit
    (ints and 0-d int32 positions), the kernel's wrapper never called."""
    cfg = tiny_test_model(max_seq_len=32, sliding_window=window or None)
    monkeypatch.setattr(tf, "decode_attention", None)
    k, v = _caches(1, 32, cfg.n_kv_heads, cfg.head_dim)
    q = torch.randn(cfg.n_heads * cfg.head_dim,
                    generator=torch.Generator().manual_seed(1))
    live = tf._live_slots(pos, mask_from, 32, cfg, q.device)
    want = _parent_attn_core(q, k[0].to(torch.float32),
                             v[0].to(torch.float32), live, cfg)
    for p, m in ((pos, mask_from),
                 (torch.tensor(pos, dtype=torch.int32),
                  torch.tensor(mask_from, dtype=torch.int32))):
        got = tf._attention(q, k[0], v[0], p, cfg, m)
        assert torch.equal(got, want)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_token_batch_on_cpu_is_the_parents_plain_path(kv_quant,
                                                              monkeypatch):
    """forward_token_batch on CPU tensors, bf16 and int8 caches: the logits
    and cache rows of the step whose attention is the parent's
    _attn_core, bit for bit; the kernel's wrapper is never called and
    nothing is counted."""
    cfg = tiny_test_model(max_seq_len=32)
    w = tf.init_random_weights(cfg, BucketConfig(bucket_size=1,
                                                 chunk_rows=128,
                                                 dtype="int8"),
                               seed=0, fuse=True, device="cpu")
    B = 3
    toks = torch.tensor([3, 9, 4], dtype=torch.int32)
    pos = torch.tensor([5, 17, 30], dtype=torch.int32)
    offs = torch.tensor([0, 4, 2], dtype=torch.int32)
    eff = torch.tensor([0.5, 1.0, 0.25])

    def step(core):
        monkeypatch.setattr(tf, "_attn_core", core)
        if kv_quant:
            kc, vc = tf.make_quant_kv_cache(cfg, "cpu", B)
            for data, _ in (kc, vc):
                data.copy_(torch.randint(-127, 128, data.shape,
                                         generator=torch.Generator()
                                         .manual_seed(2)))
            for _, scale in (kc, vc):
                scale.fill_(0.01)
        else:
            kc, vc = tf.make_batch_kv_cache(cfg, B, "cpu")
            kc.copy_(torch.randn(kc.shape, generator=torch.Generator()
                                 .manual_seed(2)))
            vc.copy_(torch.randn(vc.shape, generator=torch.Generator()
                                 .manual_seed(3)))
        out = tf.forward_token_batch(w, cfg, toks, pos, kc, vc, eff,
                                     offs=offs, impl="kernel",
                                     kv_quant=kv_quant)
        return out, kc, vc

    monkeypatch.setattr(tf, "decode_attention", None)
    before = dict(LAUNCHES)
    got = step(tf._attn_core)
    want = step(_parent_attn_core)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        for x, y in zip(a if kv_quant else [a], b if kv_quant else [b]):
            assert torch.equal(x, y)
    assert LAUNCHES == before


def test_k8_route_takes_only_what_the_kernel_takes():
    """K8 for bf16 caches on the card with heads 8..256 wide (a multiple of
    8) shared by at most 64 query heads; the plain version for the CPU,
    other cache types and other heads."""
    mistral = tiny_test_model(n_heads=32, n_kv_heads=8, head_dim=128)
    assert tf.k8_route(CUDA, torch.bfloat16, mistral)
    assert tf.k8_route(CUDA, torch.bfloat16,
                       tiny_test_model(n_heads=32, n_kv_heads=32))
    assert tf.k8_route(CUDA, torch.bfloat16,
                       tiny_test_model(n_heads=64, n_kv_heads=1, head_dim=8))
    assert tf.k8_route(CUDA, torch.bfloat16,
                       tiny_test_model(head_dim=256))
    assert not tf.k8_route(torch.device("cpu"), torch.bfloat16, mistral)
    for dtype in (torch.float32, torch.int8, torch.float16):
        assert not tf.k8_route(CUDA, dtype, mistral)
    for D in (264, 12, 4):
        assert not tf.k8_route(CUDA, torch.bfloat16,
                               tiny_test_model(head_dim=D))
    assert not tf.k8_route(CUDA, torch.bfloat16,
                           tiny_test_model(n_heads=65, n_kv_heads=1))
    assert "from 8 to 256" in k8.decode_limits(264, 4)
    assert "rep 65" in k8.decode_limits(128, 65)
    assert k8.decode_limits(128, 4) is None


@pytest.mark.parametrize("B,KV,rep,S,D", [
    (1, 8, 4, 2048, 128), (16, 8, 4, 2048, 128), (1, 32, 1, 4096, 128),
    (16, 32, 1, 4096, 128), (4, 2, 2, 4096, 64), (1, 1, 64, 32768, 256),
    (3, 2, 12, 100, 72)])
def test_decode_plan_adapts_to_the_shapes(B, KV, rep, S, D):
    """The chunks cover the cache, in whole tiles of 8192 elements (at
    most 128 rows, at least 8 warp steps), at most 128 of them a slot; the
    grid at the whole cache stays within 8 blocks an SM of 132 unless two
    tiles a chunk already pass it, and the chunks are the shortest from
    two tiles that do; query heads go 8 at most to a block."""
    sms = 132
    p = k8.decode_plan(B, KV, rep, S, D, sms)
    D2 = 1 << (D - 1).bit_length()
    assert p.tile == max(min(128, 8192 // D2), 2048 // D2)
    assert p.chunk == p.tile * p.chunk_tiles
    assert p.n_chunks * p.chunk >= S > (p.n_chunks - 1) * p.chunk
    assert p.n_chunks <= 128
    assert p.repg == min(8, 1 << (rep - 1).bit_length())
    assert p.groups * p.repg >= rep > (p.groups - 1) * p.repg
    rows = B * KV * p.groups
    n_tiles = -(-S // p.tile)
    assert p.chunk_tiles == min(2, n_tiles) or (
        rows * -(-S // (p.chunk // 2)) > 8 * sms
        or -(-S // (p.chunk // 2)) > 128)
    assert rows * p.n_chunks <= 8 * sms or p.n_chunks == 1 or (
        p.chunk_tiles == 2)


def test_decode_plan_chunks_for_the_main_paths():
    """Chat at Mistral-7B's heads takes two tiles a chunk (128 blocks at
    2048 slots); 16 serving slots take longer chunks, so their grid stays
    within 8 blocks an SM."""
    chat = k8.decode_plan(1, 8, 4, 2048, 128, 132)
    serve = k8.decode_plan(16, 8, 4, 2048, 128, 132)
    assert (chat.tile, chat.chunk_tiles, chat.n_chunks) == (64, 2, 16)
    assert serve.chunk > chat.chunk
    assert 16 * 8 * serve.n_chunks <= 8 * 132


def _online(state, s, vt):
    """One online-softmax update of (m, l, acc) [heads], [heads],
    [heads, D] by scores s [heads, rows] (-inf where dead) and values vt
    [rows, D]; a state whose rows are all dead keeps m = -inf."""
    m, l, acc = state
    mt = torch.maximum(m, s.max(dim=1).values)
    ref = torch.where(torch.isinf(mt), torch.zeros_like(mt), mt)
    e = torch.exp2(s - ref[:, None])
    corr = torch.exp2(m - ref)
    return mt, l * corr + e.sum(dim=1), acc * corr[:, None] + e @ vt


def _merge(states):
    """(m, l, acc) states of one set of heads merged by their maxima."""
    M = torch.stack([m for m, _, _ in states]).max(0).values
    f = [torch.exp2(m - M) for m, _, _ in states]
    return (M, sum(fi * l for fi, (_, l, _) in zip(f, states)),
            sum(fi[:, None] * a for fi, (_, _, a) in zip(f, states)))


def _mirror(q, k, v, pos, mask_from, window, plan, warps=8):
    """The kernel's blocking, in float64, scores in base 2: for each slot,
    KV head and head group, the chunks [c_lo, c_hi] of its live range;
    in each chunk's block, each warp's rows of every tile (steps of RPW =
    256 / D2 rows, every warps-th step) under the warp's own online
    softmax, the warps merged at the chunk's end; one chunk written as it
    is, several combined in chunk order. Slots with no live row get 0."""
    B, S, KV, D = k.shape
    rep = q.shape[1] // (KV * D)
    qh = q.double().reshape(B, KV, rep, D)
    kd, vd = k.double(), v.double()
    out = torch.zeros((B, KV, rep, D), dtype=torch.float64)
    CH, TR = plan.chunk, plan.tile
    D2 = max(8, 1 << (D - 1).bit_length())
    RPW = 256 // D2
    scale = math.log2(math.e) / math.sqrt(D)
    for b in range(B):
        p = int(pos[b])
        hi, lo = min(p, S - 1), max(int(mask_from[b]), 0)
        if window:
            lo = max(lo, p - window + 1)
        if lo > hi:
            continue
        for g in range(KV):
            for rg in range(plan.groups):
                heads = list(range(rg * plan.repg,
                                   min(rep, (rg + 1) * plan.repg)))
                n = len(heads)
                parts = []
                for c in range(lo // CH, hi // CH + 1):
                    r0, r1 = max(lo, c * CH), min(hi, c * CH + CH - 1)
                    states = [(torch.full((n,), -math.inf,
                                          dtype=torch.float64),
                               torch.zeros(n, dtype=torch.float64),
                               torch.zeros((n, D), dtype=torch.float64))
                              for _ in range(warps)]
                    seen = []
                    for t0 in range(r0 // TR * TR, r1 + 1, TR):
                        for w in range(warps):
                            rows = torch.tensor([
                                t0 + (j * warps + w) * RPW + ri
                                for j in range(TR // warps // RPW)
                                for ri in range(RPW)])
                            seen += rows.tolist()
                            on = (rows >= r0) & (rows <= r1)
                            kt = torch.where(on[:, None],
                                             kd[b, rows.clamp(max=S - 1), g],
                                             0)
                            vt = torch.where(on[:, None],
                                             vd[b, rows.clamp(max=S - 1), g],
                                             0)
                            s = qh[b, g, heads] @ kt.T * scale
                            s = torch.where(on[None], s, -math.inf)
                            states[w] = _online(states[w], s, vt)
                    assert sorted(seen) == list(range(r0 // TR * TR,
                                                      r1 // TR * TR + TR))
                    parts.append(_merge(states))
                m, l, acc = _merge(parts) if len(parts) > 1 else parts[0]
                out[b, g, heads] = acc / l[:, None]
    return out.reshape(B, -1)


def _ref64(q, k, v, pos, mask_from, window):
    """The plain version's semantics in float64."""
    B, S, KV, D = k.shape
    rep = q.shape[1] // (KV * D)
    t = torch.arange(S)
    live = (t <= pos[:, None]) & (t >= mask_from[:, None])
    if window:
        live &= t > pos[:, None] - window
    s = torch.einsum("bkrd,btkd->bkrt", q.double().reshape(B, KV, rep, D),
                     k.double()) / math.sqrt(D)
    s = torch.where(live[:, None, None], s, -math.inf)
    pr = torch.nan_to_num(torch.softmax(s, dim=-1))
    return torch.einsum("bkrt,btkd->bkrd", pr, v.double()).reshape(B, -1)


@pytest.mark.parametrize("B,S,KV,rep,D,sms", [
    (1, 2048, 8, 4, 128, 132), (16, 2048, 8, 4, 128, 132),
    (1, 4096, 32, 1, 64, 132), (16, 4096, 2, 2, 128, 132),
    (2, 300, 1, 12, 72, 4)])
def test_mirror_of_the_kernel_matches_the_plain_version(B, S, KV, rep, D,
                                                        sms):
    """The kernel's chunks, tiles, skipped blocks and combine, mirrored in
    float64, against the plain version's semantics at positions 0, one
    short of a chunk, at a chunk, S - 1 and ragged ones; left pads, a slot
    with no live row (0) and a sliding window."""
    plan = k8.decode_plan(B, KV, rep, S, D, sms)
    CH = plan.chunk
    g = torch.Generator().manual_seed(5)
    k = torch.randn((B, S, KV, 1), generator=g).expand(B, S, KV, D)
    k = (k + torch.randn((B, S, KV, D), generator=g)).to(torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=g).to(torch.bfloat16)
    q = torch.randn((B, KV * rep * D), generator=g)
    edge = [0, CH - 1, CH, S - 1, min(S - 1, 2 * CH + 5)]
    pos = torch.tensor([edge[i % len(edge)] if i < len(edge) else
                        int(torch.randint(0, S, (1,), generator=g))
                        for i in range(B)], dtype=torch.int32)
    for mf, window in ((torch.zeros(B, dtype=torch.int32), 0),
                       (torch.clamp(pos - 37, min=0) % 11, 0),
                       (torch.where(torch.arange(B) % 2 == 1, pos + 1,
                                    torch.clamp(pos // 3, max=40)).to(
                                        torch.int32), 0),
                       (torch.zeros(B, dtype=torch.int32), CH + 3)):
        want = _ref64(q, k, v, pos, mf, window)
        got = _mirror(q, k, v, pos, mf, window, plan)
        assert torch.allclose(got, want, rtol=0, atol=1e-12), (mf, window)
        plain = k8.decode_attention(q, k, v, pos, mf, window)
        assert torch.allclose(plain.double(), want, rtol=0, atol=1e-5)
        empty = (mf > pos)
        assert not plain[empty].any()


def test_live_rows_is_the_live_range():
    """live_rows against the mask _live_slots makes, with a window and
    left pads, positions past the cache clamped to its last row."""
    S = 40
    for window in (0, 7):
        cfg = tiny_test_model(max_seq_len=S, sliding_window=window or None)
        for pos in (0, 3, 6, 7, 20, 39):
            for mf in (0, 2, 5, 21):
                want = int(tf._live_slots(pos, mf, S, cfg, "cpu").sum())
                assert k8.live_rows(pos, mf, window, S) == want
    assert k8.live_rows(45, 3, 0, S) == S - 3


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_model(max_seq_len=64)
    w = tf.init_random_weights(cfg, BucketConfig(bucket_size=1,
                                                 chunk_rows=128,
                                                 dtype="int8"),
                               seed=0, fuse=True, device="cpu")
    return cfg, w


def k8_on(monkeypatch):
    """The K8 route on CPU tensors: the counters read the route through
    transformer.k8_route, as the attention calls do."""
    monkeypatch.setattr(tf, "k8_route", lambda *a: True)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_batch_positions_state_the_rows_k8_reads(tiny, spec_k,
                                                 monkeypatch):
    """Under K8 BatchEngine.positions reads every slot's live rows, idle
    slots included, left pads left out; spec_k drafts at positions + i,
    clamped at the cache's last row; live counts the active slots only.
    The plain route reads every slot's whole cache."""
    cfg, w = tiny
    S = cfg.max_seq_len
    be = BatchEngine(w, cfg, batch_size=4, pad_to=8, spec_k=spec_k,
                     device="cpu")
    be.admit(0, 0, [1, 2, 3], 4, 0.5)             # P 8, offset 5
    be.admit(2, 1, list(range(1, 12)), 4, 0.5)    # P 16, offset 5
    be.pos_host[3] = 9                            # an idle slot
    k = spec_k or 1
    plain = be.positions(be.active())
    live = sum((8 + i + 1 - 5) + (16 + i + 1 - 5) for i in range(k))
    assert plain == (live, k * 4 * S)
    k8_on(monkeypatch)
    idle = sum((0 + i + 1) + (9 + i + 1) for i in range(k))
    assert be.positions(be.active()) == (live, live + idle)
    # near the end of the cache: slot 2 at the last rows
    be.pos_host[2] = S - 2
    near = [min(S - 2 + i, S - 1) + 1 - 5 for i in range(k)]
    got = be.positions(be.active())
    assert got[0] == sum(8 + i + 1 - 5 for i in range(k)) + sum(near)
    assert got[1] == got[0] + idle


def test_turn_attrs_state_the_rows_k8_reads(tiny, monkeypatch):
    """Under K8 a turn's read positions are its live ones (each step's
    position + 1, within a sliding window), near the end of the cache
    too; the plain route reads every slot each step."""
    cfg, w = tiny
    S = cfg.max_seq_len
    s = ChatSession(w, cfg, pad_to=4, device="cpu")
    cases = [(pos0, n, sum(p + 1 for p in range(pos0, pos0 + n)))
             for pos0, n in ((0, 5), (S - 9, 9))]
    for pos0, n, want in cases:
        s.pos = pos0
        span = {}
        s._turn_attrs(span, n)
        assert span == {"live_positions": want, "read_positions": n * S}
    k8_on(monkeypatch)
    for pos0, n, want in cases:
        s.pos = pos0
        span = {}
        s._turn_attrs(span, n)
        assert span == {"live_positions": want, "read_positions": want}
    cfg_w = dataclasses.replace(cfg, sliding_window=6)
    sw = ChatSession(w, cfg_w, pad_to=4, device="cpu")
    sw.pos = 3
    span = {}
    sw._turn_attrs(span, 8)
    want = live_positions(3, 8, 6)
    assert span == {"live_positions": want, "read_positions": want}


@pytest.mark.parametrize("rep,groups", [(1, 1), (4, 1), (8, 1), (12, 2),
                                        (16, 2), (64, 8)])
def test_attention_reads_follow_the_route(rep, groups):
    """attention_reads: on K8's route (a bf16 cache on the card) the live
    rows once a head group of K8's launch (head_groups, as decode_plan
    groups them); every row of every call on the CPU, for an int8 cache
    and for a KV mode whose hooks replace _attention."""
    cfg = dataclasses.replace(tiny_test_model(max_seq_len=64),
                              n_kv_heads=1, n_heads=rep)
    cuda = torch.device("cuda")
    assert k8.head_groups(rep) == groups
    assert k8.decode_plan(2, 1, rep, 64, cfg.head_dim, 132).groups == groups
    assert tf.attention_reads(30, 3, 64, cfg, torch.bfloat16,
                              cuda) == 30 * groups
    for dtype, dev, hooked in ((torch.bfloat16, torch.device("cpu"), False),
                               (torch.int8, cuda, False),
                               (torch.bfloat16, cuda, True)):
        assert tf.attention_reads(30, 3, 64, cfg, dtype, dev,
                                  hooked=hooked) == 3 * 64
