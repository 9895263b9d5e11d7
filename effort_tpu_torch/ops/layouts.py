"""Bucketized weight container.

Each weight matrix is stored transposed (rows = input dims). Every row is
split into buckets of B consecutive output columns; each bucket's elements
are sorted by |w| descending, so "rank k" collects the k-th largest element
of every bucket. The effort knob selects, per input row i, a rank prefix n_i
(the rule stats[i,k]*|v_i| > cutoff is monotone in k because stats decrease
with rank).

Values are grouped into blocks of shape [G, out/B]: block (chunk g, rank k)
holds the rank-k bucket rows of input rows g*G..g*G+G-1. The layout is the
JAX package's, array for array, so either package reads the other's
containers (models/bridge.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_POS_BITS = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5}
TENSOR_FIELDS = ("vals", "pos", "stats", "probes", "probe_dims", "scales",
                 "outlier_vals", "outlier_idx", "dense", "seg_order")
META_FIELDS = ("in_dim", "out_dim", "bucket_size", "chunk_rows", "n_ranks",
               "n_experts", "dtype_name", "perm_segment", "rows_sorted")


def take(t: torch.Tensor, expert) -> torch.Tensor:
    """t[expert] for an instance given as an int or as a 0-d int32 tensor
    on t's device. A tensor is read by index_select on the device (a copy
    of one instance): indexing with a 0-d tensor would read it back to the
    host and wait for the card."""
    if isinstance(expert, int):
        return t[expert]
    return t.index_select(0, expert.reshape(1))[0]


@dataclasses.dataclass
class BucketedMatrix:
    """One bucketized weight matrix (possibly several instances: experts,
    or layers packed on one axis).

    Shapes (E = n_experts, K = n_ranks kept, NB = (in_dim // G) * K blocks
    per instance, OB = out_dim // B):

      vals:   [E*NB + 1, G, OB]  bf16 | int8 | uint8 (int4, two per byte);
              the final block is zeros.
      pos:    [E*NB + 1, G, OB*log2(B)//8] uint8 — within-bucket positions,
              bit-packed by pack_positions(). B = 1 stores a [.., 1, 128]
              placeholder that nothing reads.
      stats:  [E, in_dim, K] f32 — mean |w| per bucket row.
      probes: [E, P] f32 — sampled weights for the cutoff quantile.
      probe_dims: [P] int32 — input dim sampled by each probe.
      scales: [E, in_dim, K] f32 or None — int8/int4 dequant scales.
      outlier_vals/outlier_idx: int4 only — exact f32 corrections.
      dense:  optional [E, in_dim, out_dim] bf16 dense copy (rows in the
              bucket layout's order) for the effort >= 1 fast path.
      seg_order: optional [E, in_dim // perm_segment] int32 — runtime input
              permutation at segment granularity.
    """

    vals: torch.Tensor
    pos: torch.Tensor
    stats: torch.Tensor
    probes: torch.Tensor
    probe_dims: torch.Tensor
    scales: Optional[torch.Tensor]
    outlier_vals: Optional[torch.Tensor]
    outlier_idx: Optional[torch.Tensor]
    dense: Optional[torch.Tensor]
    seg_order: Optional[torch.Tensor]
    in_dim: int
    out_dim: int
    bucket_size: int
    chunk_rows: int
    n_ranks: int
    n_experts: int
    dtype_name: str
    perm_segment: int = 1
    # input rows are in calibrated importance order (required for
    # row-prefix truncated loading, models/weights.truncate_bucketed)
    rows_sorted: bool = False

    def to(self, device) -> "BucketedMatrix":
        return dataclasses.replace(self, **{
            f: (None if getattr(self, f) is None
                else getattr(self, f).to(device)) for f in TENSOR_FIELDS})

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_buckets(self) -> int:
        return self.out_dim // self.bucket_size

    @property
    def n_chunks(self) -> int:
        return self.in_dim // self.chunk_rows

    @property
    def blocks_per_expert(self) -> int:
        return self.n_chunks * self.n_ranks

    @property
    def zero_block_id(self) -> int:
        return self.n_experts * self.blocks_per_expert

    @property
    def pos_bits(self) -> int:
        return _POS_BITS[self.bucket_size]

    @property
    def vals_packed(self) -> bool:
        """int4 values stored two per byte (uint8 nibbles of q+8)."""
        return self.vals.dtype == torch.uint8

    def permute_v(self, v: torch.Tensor, expert) -> torch.Tensor:
        """Apply the runtime input permutation to v [..., in] (leading axes
        are slots); expert an int or a 0-d int32 device tensor (take).
        Under truncated loading of a baked (importance-sorted) layout
        in_dim < in: the dropped tail is the least important rows, which
        the matvec ignores."""
        if self.seg_order is None:
            return v[..., :self.in_dim] if v.shape[-1] > self.in_dim else v
        lead = v.shape[:-1]
        return v.reshape(*lead, -1, self.perm_segment)[
            ..., take(self.seg_order, expert).long(), :].reshape(*lead, -1)

    def dim_order_full(self, expert: int = 0) -> Optional[torch.Tensor]:
        """Full row permutation derived from seg_order."""
        if self.seg_order is None:
            return None
        seg = self.perm_segment
        base = (self.seg_order[expert].long()[:, None] * seg
                + torch.arange(seg, device=self.seg_order.device))
        return base.reshape(-1)

    def pos_unpacked(self) -> torch.Tensor:
        """Positions as int8 [E*NB+1, G, OB] (packing padding sliced off)."""
        if self.bucket_size == 1:
            nblk = self.n_experts * self.blocks_per_expert + 1
            return torch.zeros((nblk, self.chunk_rows, self.n_buckets),
                               dtype=torch.int8, device=self.device)
        return unpack_positions(self.pos,
                                self.bucket_size)[..., :self.n_buckets]

    def vals_unpacked(self) -> torch.Tensor:
        """Bucket values with int4 packing undone (int8 in [-7, 7]);
        identity for bf16/int8 storage."""
        if not self.vals_packed:
            return self.vals
        return (unpack_positions(self.vals, 16).to(torch.int16) - 8
                ).to(torch.int8)[..., :self.n_buckets]

    def reconstruct_dense(self, expert: int = 0,
                          permuted_space: bool = False) -> torch.Tensor:
        """Scatter vals back to a dense [in_dim, out_dim] f32 matrix.

        permuted_space=True keeps rows in the bucket layout's order (the
        space of the `dense` field)."""
        E, K, G, B = (self.n_experts, self.n_ranks, self.chunk_rows,
                      self.bucket_size)
        nb = self.n_buckets
        vals = self.vals_unpacked()[:-1].reshape(
            E, K, self.n_chunks, G, nb)[expert]
        vals = vals.permute(1, 2, 0, 3).reshape(self.in_dim, K, nb)
        vals = _dequant(vals, self.scales[expert]
                        if self.scales is not None else None)
        if B == 1:
            dense = vals[:, 0, :]
        else:
            pos = self.pos_unpacked()[:-1].reshape(
                E, K, self.n_chunks, G, nb)[expert]
            pos = pos.permute(1, 2, 0, 3).reshape(self.in_dim, K, nb)
            one_hot = torch.nn.functional.one_hot(pos.long(), B).to(
                vals.dtype)
            dense = torch.einsum("ikj,ikjp->ijp", vals, one_hot)
        dense = dense.reshape(self.in_dim, self.out_dim)
        if self.outlier_vals is not None:
            # rows a truncation dropped (>= in_dim) add 0, as JAX's
            # scatter drops them
            oidx = self.outlier_idx[expert].long()
            rows = oidx[:, 0]
            flat = dense.reshape(-1).clone()
            flat.index_add_(0, rows.clamp(max=self.in_dim - 1) * self.out_dim
                            + oidx[:, 1],
                            torch.where(rows < self.in_dim,
                                        self.outlier_vals[expert], 0.0))
            dense = flat.reshape(self.in_dim, self.out_dim)
        if not permuted_space:
            order = self.dim_order_full(expert)
            if order is not None:
                dense = dense[torch.argsort(order)]
        return dense

    def memory_bytes(self) -> int:
        total = 0
        for a in (self.vals, self.pos, self.stats, self.probes, self.scales,
                  self.outlier_vals, self.outlier_idx, self.seg_order):
            if a is not None:
                total += a.numel() * a.element_size()
        return total


def concat_bucketed(bms, n_experts: int = None) -> BucketedMatrix:
    """Concatenate BucketedMatrix parts along the instance axis (the
    trailing all-zero block is kept once). bms: a list, or an iterable of
    parts holding n_experts instances in all, consumed one part at a
    time: each field is allocated once for every instance and a part is
    copied in as it comes, so a builder that makes the parts one by one
    never holds them all beside the result (at a full model's size, that
    is twice its largest projection)."""
    if isinstance(bms, list):
        if len(bms) == 1:
            return bms[0]
        n_experts = sum(b.n_experts for b in bms)
    out, first, at = {}, None, 0
    per_instance = [f for f in TENSOR_FIELDS if f != "probe_dims"]
    for b in bms:
        if first is None:
            first = b
        for f in per_instance:
            src, zb = getattr(b, f), int(f in ("vals", "pos"))
            if (src is None) != (getattr(first, f) is None):
                raise ValueError(f"{f} present in only some parts")
            if src is None:
                continue
            per = (src.shape[0] - zb) // b.n_experts
            if f not in out:
                out[f] = torch.empty((n_experts * per + zb,)
                                     + tuple(src.shape[1:]),
                                     dtype=src.dtype, device=src.device)
                if zb:
                    out[f][-1:] = src[-1:]
            out[f][at * per:(at + b.n_experts) * per] = src[:src.shape[0]
                                                            - zb]
        at += b.n_experts
    if at != n_experts:
        raise ValueError(f"parts hold {at} instances, not {n_experts}")
    return dataclasses.replace(first, n_experts=n_experts,
                               **{f: out.get(f) for f in per_instance})


def _dequant(vals: torch.Tensor, scales: Optional[torch.Tensor]):
    """Dequantize bucket values to f32. vals [in,K,nb]; scales [in,K]."""
    if vals.dtype in (torch.bfloat16, torch.float32):
        return vals.float()
    if scales is None:
        raise ValueError("integer bucket values need scales")
    return vals.float() * scales[..., None]


def probe_sample_indices(in_dim: int, out_dim: int,
                         n_probes: int) -> np.ndarray:
    """Deterministic (input-dim, column) sample used for probes: uniformly
    strided input dims, so the runtime fetches v[probe_dims] with a
    strided slice."""
    stride = max(1, -(-in_dim // n_probes))
    n = in_dim // stride
    dims = np.arange(n, dtype=np.int64) * stride
    cols = dims % out_dim
    return np.stack([dims, cols], axis=1).astype(np.int32)


def sample_stride(in_dim: int, n_samples: int) -> int:
    """The stride of a stored sample of n_samples probes over in_dim rows:
    in_dim // n_samples, the stride probe_sample_indices took (a sample of
    P = in_dim // s probes gives s back for any in_dim >= s (s + 1)). A
    budget's stride, ceil(in_dim / n), is not its inverse: Llama-2-7B's
    w2 (11008 rows, 4096 probes: stride 3, 3669 probes) gives 4 from
    3669, which the JAX package's runtime takes (its reference route
    raises on that matrix, its kernel refuses it)."""
    return max(1, in_dim // n_samples)


def strided_sample(v: torch.Tensor, in_dim: int,
                   n_samples: int) -> torch.Tensor:
    """v[..., probe_dims]: the rows of a stored sample of n_samples probes
    (bm.probes.shape[-1]) as a strided slice (matches
    probe_sample_indices)."""
    stride = sample_stride(in_dim, n_samples)
    return v[..., :n_samples * stride:stride]


def pack_positions(pos: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """[..., OB] small ints -> packed uint8 [..., OB*bits//8].

    Strided packing: byte jb holds elements {jb, jb+OBp, jb+2*OBp, ...}
    (OBp = OB*bits//8), element t*OBp+jb at bit shift t*bits."""
    bits = _POS_BITS[bucket_size]
    per_byte = 8 // bits
    ob = pos.shape[-1]
    if ob % per_byte:
        raise ValueError(f"width {ob} not a multiple of {per_byte}")
    p = pos.to(torch.uint8).reshape(pos.shape[:-1]
                                    + (per_byte, ob // per_byte))
    out = p[..., 0, :].clone()
    for t in range(1, per_byte):
        out |= p[..., t, :] << (t * bits)
    return out


def unpack_positions(packed: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Inverse of pack_positions: [..., OBp] uint8 -> [..., OB] int8."""
    bits = _POS_BITS[bucket_size]
    per_byte = 8 // bits
    obp = packed.shape[-1]
    shifts = (torch.arange(per_byte, dtype=torch.uint8,
                           device=packed.device) * bits)[:, None]
    parts = (packed[..., None, :] >> shifts) & ((1 << bits) - 1)
    return parts.reshape(packed.shape[:-1] + (obp * per_byte,)).to(
        torch.int8)
