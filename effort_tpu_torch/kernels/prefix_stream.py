"""Rank-prefix streaming (bucket_size >= 2): the dispatch select_stream,
the stream K5 (stream_matvec, csrc/stream_matvec.cu) and its plain version,
and what K4-K7's wrappers share (limits, launch plans, plain products).

K5 replaces effort_tpu/kernels/prefix_stream.py:stream_matvec -> _kernel.
The selection rule (stats[i, k] * |v_i| > cutoff) with the calibrated row
order puts each rank slab's selected rows at its front, so K5 streams a
prefix of every rank slab: C_k chunks holding tau of the rank's selected
mass, rounded up to tiles of TGB chunks, rows in the rounded-up tail
included. It is bound by the streamed bytes (values + packed positions of
the live tiles) over the card's memory rate; its body, shared with K4, is
a shared-memory ring that the copy engine (TMA) fills, one producer lane
asking for each stage (csrc/rank_prefix.cuh). select_stream is plain
tensor ops, as in the JAX package: cum_tiles and base_blocks stay on the
device, and the kernel reads them there (no host sync).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from effort_tpu_torch.kernels import LAUNCHES, _build
from effort_tpu_torch.ops.effort import rank_inputs
from effort_tpu_torch.ops.layouts import (_POS_BITS, BucketedMatrix,
                                          unpack_positions)

LAUNCHES["stream_matvec"] = 0
_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.uint8: 2}
_MAX_RANKS = 32
_MAX_TILE_ROWS = 2048
_ACCS = 64                  # accumulators a thread (csrc/rank_prefix.cuh)
_ROW_WARPS = 4              # warps of a block; warp w takes rows r = w mod 4
_RING_THREADS = 32 * (_ROW_WARPS + 1)   # the ring kernels: + a producer warp
_RING_BLOCKS = 396          # the ring kernels (K4-K7): three blocks an SM
_GATHER_MAX_ROWS = 32       # G a gather stage takes (csrc/block_gather.cuh)


class StreamSelection(NamedTuple):
    cum_tiles: torch.Tensor    # [K+1] int32: cumulative tile counts
    base_blocks: torch.Tensor  # [K] int32: first block id of each rank slab
    u_scaled: torch.Tensor     # [K, n_chunks, G] f32


def coverage_lengths(mass: torch.Tensor, tau: float) -> torch.Tensor:
    """C per row of mass [..., nc, G] (selected mass per row): the shortest
    chunk prefix holding tau of the total, 1 <= C <= nc. Masses add in f64
    (exact in any order, so C does not hang on the order of the sums) and
    each chunk prefix is rounded to f32 once, as the kernels sum."""
    nc = mass.shape[-2]
    cum = torch.cumsum(mass.to(torch.float64).sum(-1), -1).to(torch.float32)
    tot = torch.amax(cum, dim=-1, keepdim=True)
    return torch.clamp((cum < tau * tot).sum(-1) + 1, max=nc).to(torch.int32)


def tile_offsets(C: torch.Tensor, tile_blocks: int) -> torch.Tensor:
    """cum_tiles [K+1] int32 from per-rank chunk counts C [K]."""
    lens = (C + tile_blocks - 1) // tile_blocks
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=C.device),
                      torch.cumsum(lens, 0, dtype=torch.int32)])


def select_stream(bm: BucketedMatrix, v: torch.Tensor, effort, expert: int,
                  tile_blocks: int = 8, tau: float = None) -> StreamSelection:
    """Per-rank prefix lengths in tiles of tile_blocks chunks (the tau
    coverage bound taken per rank), the slabs' first block ids and the
    masked, scaled input. effort: a float, an f32 tensor or a 16.16 int32
    tensor; tau: the coverage target, default fused_stream._TAU."""
    from effort_tpu_torch.kernels.fused_stream import _TAU
    tau = _TAU if tau is None else tau
    K, G, nc = bm.n_ranks, bm.chunk_rows, bm.n_chunks
    vp, n, u = rank_inputs(bm, v, effort, expert)
    ranks = torch.arange(K, dtype=torch.int32, device=u.device)
    sel_mass = torch.where(ranks[:, None] < n[None, :],
                           bm.stats[expert].T * torch.abs(vp)[None, :], 0.0)
    C = coverage_lengths(sel_mass.reshape(K, nc, G), tau)
    return StreamSelection(cum_tiles=tile_offsets(C, tile_blocks),
                           base_blocks=(expert * K + ranks) * nc,
                           u_scaled=u.reshape(K, nc, G))


# ---- what the rank-prefix kernels' plain versions share -----------------

def row_values(bm: BucketedMatrix, rows: torch.Tensor) -> torch.Tensor:
    """Value rows `rows` (global: block * G + row) as f32 [n, OB], integer
    codes undequantized (the scales ride in u)."""
    OB = bm.n_buckets
    w = bm.vals.reshape(-1, bm.vals.shape[2]).index_select(0, rows)
    if bm.vals_packed:
        w = torch.cat([(w & 15).to(torch.float32) - 8.0,
                       (w >> 4).to(torch.float32) - 8.0], dim=-1)
    return w[:, :OB].to(torch.float32)


def row_positions(bm: BucketedMatrix, rows: torch.Tensor,
                  pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Within-bucket positions of rows `rows` as [n, OB]: unpacked from
    bm.pos, or read from `pos`, one position a column."""
    src = bm.pos if pos is None else pos
    p = src.reshape(-1, src.shape[2]).index_select(0, rows)
    if pos is None:
        p = unpack_positions(p, bm.bucket_size)
    return p[:, :bm.n_buckets]


def split_sum(bm: BucketedMatrix, first_rows: torch.Tensor,
              u_rows: torch.Tensor, splits: int,
              pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stream and gather bodies' function in their order of sums: item
    b (a tile, or a gathered block) is n_r consecutive global rows from
    first_rows[b], weighted by u_rows[b] [n_r]; split s takes items s,
    s + splits, ...; warp w of it adds the rounded products u_r * W[r, j]
    of rows r = w mod _ROW_WARPS to its accumulator (j, pos[r, j]) in row
    order; a split's sum adds its warps' in warp order, and y [OB*B] the
    splits that took an item, in split order. The CUDA kernels round and
    order every sum the same way, so the two agree bit for bit."""
    OB, B = bm.n_buckets, bm.bucket_size
    n, n_r = u_rows.shape
    dev = u_rows.device
    rounds = -(-n // splits)
    pad = rounds * splits - n
    if pad:                        # items no split takes: u = 0 adds 0
        first_rows = torch.cat([first_rows, first_rows.new_zeros(pad)])
        u_rows = torch.cat([u_rows, u_rows.new_zeros((pad, n_r))])
    rows = (first_rows[:, None] + torch.arange(n_r, device=dev)).reshape(-1)
    shape = (rounds, splits, n_r, OB, 1)
    X = (u_rows.reshape(-1, 1) * row_values(bm, rows)).reshape(shape)
    P = row_positions(bm, rows, pos).reshape(shape)
    ps = torch.arange(B, device=dev)
    zero = torch.zeros((), device=dev)
    acc = [torch.zeros((splits, OB, B), dtype=torch.float32, device=dev)
           for _ in range(_ROW_WARPS)]
    for i in range(rounds):
        for r in range(n_r):
            w = r % _ROW_WARPS
            acc[w] = acc[w] + torch.where(P[i, :, r] == ps, X[i, :, r], zero)
    part = acc[0]
    for w in range(1, _ROW_WARPS):
        part = part + acc[w]
    y = torch.zeros(OB * B, dtype=torch.float32, device=dev)
    for s in range(min(splits, n)):
        y = y + part[s].reshape(-1)
    return y


def stream_product_ref(bm: BucketedMatrix, u: torch.Tensor,
                       cum_tiles: torch.Tensor, base: torch.Tensor,
                       tile_blocks: int) -> torch.Tensor:
    """The stream's function: y [OB*B] = for every rank k, the
    cum_tiles[k+1] - cum_tiles[k] tiles of tile_blocks chunks from block
    base[k] on against u[k] [in], summed as the kernel sums."""
    K, G = bm.n_ranks, bm.chunk_rows
    n_r = tile_blocks * G
    cum, base = cum_tiles.tolist(), base.tolist()
    firsts, us = [], []
    for k in range(K):
        for j in range(cum[k + 1] - cum[k]):
            firsts.append((base[k] + j * tile_blocks) * G)
            us.append(u[k, j * n_r:(j + 1) * n_r])
    return split_sum(bm, torch.tensor(firsts, device=u.device),
                     torch.stack(us), stream_plan(bm, tile_blocks)[2])


def stream_matvec_ref(bm: BucketedMatrix, sel: StreamSelection,
                      tile_blocks: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K5: y [OB*B] f32."""
    return stream_product_ref(bm, sel.u_scaled.reshape(bm.n_ranks, -1),
                              sel.cum_tiles, sel.base_blocks, tile_blocks)


# ---- what the rank-prefix kernels' wrappers share ------------------------

def cols_per_thread(B: int, packed: bool) -> int:
    """Position bytes a thread of the stream and gather bodies owns."""
    per_byte = 8 // _POS_BITS[B] if packed else 1
    return _ACCS // (per_byte * B)


def body_limits(bm: BucketedMatrix, rows: int,
                pos: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why the stream and gather bodies (csrc/rank_prefix.cuh) cannot take
    this container, or None. rows: u rows a tile stages (TGB*G, or G).
    pos: the unpacked positions K7 reads instead of bm.pos."""
    E, K, G, nc, B = (bm.n_experts, bm.n_ranks, bm.chunk_rows, bm.n_chunks,
                      bm.bucket_size)
    OB = bm.n_buckets
    if B < 2:
        return "the rank-prefix kernels need bucket_size >= 2"
    if K > _MAX_RANKS or rows > _MAX_TILE_ROWS:
        return f"{K} ranks / {rows} rows a tile outside the kernels' limits"
    nblk = E * K * nc + 1
    vals = bm.vals
    if vals.dtype not in _KIND or vals.ndim != 3 \
            or not vals.is_contiguous() or tuple(vals.shape[:2]) != (nblk, G):
        return (f"vals {vals.dtype} {tuple(vals.shape)}: want contiguous "
                f"bf16/int8/uint8 [{nblk}, {G}, *]")
    width = vals.shape[2] * (2 if bm.vals_packed else 1)
    if (vals.shape[2] * vals.element_size()) % 16 or width < OB \
            or (not bm.vals_packed and width != OB):
        return f"vals width {vals.shape[2]} does not fit {OB} buckets"
    packed = pos is None
    p = bm.pos if packed else pos
    per_byte = 8 // _POS_BITS[B] if packed else 1
    if p.dtype not in (torch.uint8, torch.int8) or p.ndim != 3 \
            or not p.is_contiguous() or tuple(p.shape[:2]) != (nblk, G) \
            or p.shape[2] % 16 or p.shape[2] * per_byte < OB:
        return f"positions {p.dtype} {tuple(p.shape)} do not fit the layout"
    if OB % cols_per_thread(B, packed):
        return (f"{OB} buckets not a multiple of "
                f"{cols_per_thread(B, packed)}")
    return None


def check_instance(bm: BucketedMatrix, expert, *tensors):
    """The instance is an int in range, or a 0-d int32 tensor on the
    weights' device (not read: the kernel trusts it, as the TPU kernel
    trusts its scalar-prefetched expert); every tensor is on the weights'
    device."""
    if isinstance(expert, torch.Tensor):
        if expert.dtype != torch.int32 or expert.numel() != 1 \
                or expert.device != bm.vals.device:
            raise ValueError(f"expert {expert.dtype} {tuple(expert.shape)} "
                             f"on {expert.device}: want one int32 on "
                             f"{bm.vals.device}")
    elif not isinstance(expert, int) or not 0 <= expert < bm.n_experts:
        raise ValueError(f"expert {expert!r} not an int in "
                         f"[0, {bm.n_experts})")
    for t in tensors:
        if t.device != bm.vals.device or t.device != bm.pos.device:
            raise ValueError(f"weights on {bm.vals.device}, an input on "
                             f"{t.device}")


# a card's ints 0, 1, ... as int32: an int instance reaches the kernels
# that read their instance on the device (K1, K4) as a pointer into this
# table, and so do K3's start slot and mask start, so both forms of each
# run one code path
_INSTANCE_IDS: dict = {}


def instance_ptr(expert, device) -> int:
    """The device address of the instance (or of any int32 a kernel reads
    on the card): a tensor's own, or an int's entry of the card's table
    of ints (grown as larger ints come; a replaced table is kept, since
    launches still queued may read it)."""
    if isinstance(expert, torch.Tensor):
        return expert.data_ptr()
    tables = _INSTANCE_IDS.setdefault(device, [])
    if not tables or tables[-1].numel() <= expert:
        n = max(1024, 2 * expert + 2)
        tables.append(torch.arange(n, dtype=torch.int32, device=device))
    return tables[-1].data_ptr() + 4 * expert


def column_blocks(bm: BucketedMatrix, pos_row_bytes: int,
                  packed: bool = True) -> int:
    """Column blocks of the ring kernels: _ROW_WARPS consumer warps whose
    32 lanes own cols_per_thread position bytes of a row each."""
    lanes = pos_row_bytes // cols_per_thread(bm.bucket_size, packed)
    return -(-lanes // 32)


def stream_plan(bm: BucketedMatrix, tile_blocks: int) -> tuple:
    """(threads, column blocks, splits) of the ring stream K4 and K5 share
    (csrc/rank_prefix.cuh ring_stream_kernel): four consumer warps and a
    producer warp a block, and as many splits of the K * nc / tile_blocks
    tiles as put at most _RING_BLOCKS blocks (all resident at once) on the
    card. The plain versions take the split count from here, so they add
    the splits as the kernel does."""
    col_blocks = column_blocks(bm, bm.pos.shape[2])
    n_work = bm.n_ranks * bm.n_chunks // tile_blocks
    splits = max(1, min(n_work, _RING_BLOCKS // col_blocks))
    return _RING_THREADS, col_blocks, splits


def gather_plan(bm: BucketedMatrix, n_ids: int, pos_row_bytes: int,
                packed: bool = True) -> tuple:
    """(threads, column blocks, splits) of the ring gather K6 and K7 share
    (csrc/block_gather.cuh ring_gather_kernel) over a list of n_ids block
    ids: the stream's block shape, and as many splits of the ids, at most
    one an id, as put at most _RING_BLOCKS blocks on the card. The split
    count comes from the packed positions' column blocks for both kernels,
    so K7 adds its splits as K6 does; the plain versions take it from
    here too."""
    splits = max(1, min(n_ids, _RING_BLOCKS // column_blocks(
        bm, bm.pos.shape[2])))
    return (_RING_THREADS, column_blocks(bm, pos_row_bytes, packed),
            splits)


def stream_matvec(bm: BucketedMatrix, sel: StreamSelection,
                  tile_blocks: int = 8) -> torch.Tensor:
    """The per-rank prefix stream of a selection: y [OB*B] f32.

    CPU tensors run the plain version (stream_matvec_ref); CUDA tensors
    launch the kernel, on the current stream without synchronising, or
    raise."""
    if not sel.u_scaled.is_cuda:
        return stream_matvec_ref(bm, sel, tile_blocks)
    K, G, nc = bm.n_ranks, bm.chunk_rows, bm.n_chunks
    if nc % tile_blocks:
        raise ValueError(f"{nc} chunks not a multiple of {tile_blocks}")
    why = body_limits(bm, tile_blocks * G)
    if why:
        raise ValueError(why)
    check_instance(bm, 0, *sel)
    for t, dt, shape in ((sel.cum_tiles, torch.int32, (K + 1,)),
                         (sel.base_blocks, torch.int32, (K,)),
                         (sel.u_scaled, torch.float32, (K, nc, G))):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"selection {t.dtype} {tuple(t.shape)}: want "
                             f"contiguous {dt} {shape}")
    dev = sel.u_scaled.device
    prow = bm.pos.shape[2]
    threads, col_blocks, splits = stream_plan(bm, tile_blocks)
    partial = torch.empty((splits, bm.out_dim), dtype=torch.float32,
                          device=dev)
    y = torch.empty(bm.out_dim, dtype=torch.float32, device=dev)
    vrow = bm.vals.shape[2] * bm.vals.element_size()
    _build.kernel_fn("stream_matvec", "effort_stream_matvec",
                     "piipiiiipppiiiiipiiipip")(
        bm.vals.data_ptr(), _KIND[bm.vals.dtype], vrow, bm.pos.data_ptr(),
        prow, vrow, bm.vals.shape[0] * G, bm.bucket_size,
        sel.cum_tiles.data_ptr(),
        sel.base_blocks.data_ptr(), sel.u_scaled.data_ptr(), K, G,
        tile_blocks, bm.in_dim, bm.n_buckets, partial.data_ptr(), splits,
        col_blocks, threads, y.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["stream_matvec"] += 1
    return y
