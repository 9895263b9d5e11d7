"""Offline conversion: HF-format safetensors -> bucketized effort checkpoint.

  - name maps for Mistral / Llama and Mixtral (both the original
    `block_sparse_moe.*` names and the experts' w1/w2/w3);
  - each matrix is bucketized by ops/bucketize.py on `device` (the card
    unless named): the source bits go to the device as they are stored,
    are widened there, bucketized, and come back as numpy for the writer;
  - output: one safetensors shard set + index.json + config.json, per-layer
    tensors named <prefix>.{vals,pos,stats,probes,scales,...}; the loader
    (models/weights.py) stacks the layers into packed BucketedMatrix
    containers.

The files are the JAX package's, byte for byte on the same source (int4
codes up to rounding ties of the quantile scale; stats, f32 means, up to
the reduction order), so either package loads the other's conversion.
Weights are stored TRANSPOSED ([in_dim, out_dim]) in bucket-block layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from effort_tpu_torch.config import BucketConfig, ModelConfig
from effort_tpu_torch.models.transformer import resolve_device
from effort_tpu_torch.ops.bucketize import bucketize, pick_chunk_rows
from effort_tpu_torch.runtime.safetensors_io import (MultiShardReader,
                                                     SafeTensorWriter)

# HF source name patterns per projection, {l}=layer, {e}=expert.
HF_NAME_MAPS = {
    "mistral": {
        "wq": "model.layers.{l}.self_attn.q_proj.weight",
        "wk": "model.layers.{l}.self_attn.k_proj.weight",
        "wv": "model.layers.{l}.self_attn.v_proj.weight",
        "wo": "model.layers.{l}.self_attn.o_proj.weight",
        "w1": "model.layers.{l}.mlp.gate_proj.weight",
        "w2": "model.layers.{l}.mlp.down_proj.weight",
        "w3": "model.layers.{l}.mlp.up_proj.weight",
        "attn_norm": "model.layers.{l}.input_layernorm.weight",
        "ffn_norm": "model.layers.{l}.post_attention_layernorm.weight",
        "norm": "model.norm.weight",
        "embed": "model.embed_tokens.weight",
        "lm_head": "lm_head.weight",
    },
    # Llama-2/3 use the same HF tensor names as Mistral
    "llama": None,   # alias, resolved in convert_checkpoint
    "mixtral": {
        "wq": "model.layers.{l}.self_attn.q_proj.weight",
        "wk": "model.layers.{l}.self_attn.k_proj.weight",
        "wv": "model.layers.{l}.self_attn.v_proj.weight",
        "wo": "model.layers.{l}.self_attn.o_proj.weight",
        "w1": "model.layers.{l}.block_sparse_moe.experts.{e}.w1.weight",
        "w2": "model.layers.{l}.block_sparse_moe.experts.{e}.w2.weight",
        "w3": "model.layers.{l}.block_sparse_moe.experts.{e}.w3.weight",
        "gate": "model.layers.{l}.block_sparse_moe.gate.weight",
        "attn_norm": "model.layers.{l}.input_layernorm.weight",
        "ffn_norm": "model.layers.{l}.post_attention_layernorm.weight",
        "norm": "model.norm.weight",
        "embed": "model.embed_tokens.weight",
        "lm_head": "lm_head.weight",
    },
}


def config_from_hf(src_dir: str,
                   max_seq_len: Optional[int] = None) -> ModelConfig:
    """A ModelConfig from the HF checkpoint's own config.json.

    max_seq_len: KV caches are preallocated to it, so the HF
    max_position_embeddings (32768 for Mistral) is capped at 4096 by
    default; pass an explicit value for longer contexts (or use
    Engine(ring_kv=True), which is unbounded regardless).
    """
    with open(os.path.join(src_dir, "config.json")) as f:
        hf = json.load(f)
    if hf.get("kv_lora_rank"):
        raise ValueError("a DeepSeek-V2 (MLA) checkpoint: conversion has no "
                         "MLA path (models/mla.assemble takes raw weights)")
    n_heads = hf["num_attention_heads"]
    dim = hf["hidden_size"]
    return ModelConfig(
        name=hf.get("model_type", "hf-model"),
        dim=dim,
        hidden_dim=hf["intermediate_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads") or n_heads,
        head_dim=hf.get("head_dim") or dim // n_heads,
        vocab_size=hf["vocab_size"],
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 1e4),
        max_seq_len=(max_seq_len if max_seq_len is not None
                     else min(hf.get("max_position_embeddings", 2048),
                              4096)),
        sliding_window=hf.get("sliding_window"),
        n_experts=hf.get("num_local_experts", 1),
        n_experts_per_tok=hf.get("num_experts_per_tok", 2),
    )


def _to_bits_bf16(x) -> np.ndarray:
    """An f32 (or bf16) tensor or array -> numpy uint16 bf16 bit patterns
    (round to nearest even, as the JAX package's astype), on the host."""
    t = torch.as_tensor(x).to(torch.bfloat16)
    return t.view(torch.int16).cpu().numpy().view(np.uint16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _source(src: MultiShardReader, name: str, device) -> torch.Tensor:
    """A source tensor as f32 on `device`: BF16 and F16 travel as stored
    and are widened there (exactly get_f32's values)."""
    a = np.array(src[name], copy=True)
    if src._reader(name).info(name)["dtype"] == "BF16":
        t = torch.from_numpy(a.view(np.int16)).to(device)
        return t.view(torch.bfloat16).float()
    return torch.from_numpy(a).to(device).float()


def _bucketize_and_store(writer: SafeTensorWriter, prefix: str,
                         w_hf: torch.Tensor, bcfg: BucketConfig,
                         store_core: bool = False, act_rms=None,
                         in_perm=None, out_perm=None):
    """w_hf: HF layout [out_features, in_features] on the device to
    bucketize on; bucketize its transpose and add the tensors to writer.

    in_perm/out_perm: baked relayout permutations (see
    models/transformer.assemble_weights); they exclude act_rms (the
    run-time seg_order calibration)."""
    wt = w_hf.T.contiguous()                       # [in, out]
    bcfg = dataclasses.replace(bcfg, chunk_rows=pick_chunk_rows(
        bcfg, wt.shape[0], wt.shape[1]))
    bm = bucketize(wt, bcfg, act_rms=act_rms, in_perm=in_perm,
                   out_perm=out_perm)
    bf16 = bm.dtype_name == "bf16"
    writer.add(prefix + ".vals",
               _to_bits_bf16(bm.vals[:-1]) if bf16
               else _np(bm.vals[:-1]), bf16_bits=bf16)
    writer.add(prefix + ".pos", _np(bm.pos[:-1]))
    writer.add(prefix + ".stats", _np(bm.stats[0]))
    writer.add(prefix + ".probes", _np(bm.probes[0]))
    if bm.scales is not None:
        writer.add(prefix + ".scales", _np(bm.scales[0]))
    if bm.outlier_vals is not None:
        writer.add(prefix + ".outlier_vals", _np(bm.outlier_vals[0]))
        writer.add(prefix + ".outlier_idx", _np(bm.outlier_idx[0]))
    if bm.seg_order is not None:
        writer.add(prefix + ".seg_order", _np(bm.seg_order[0]))
    del bm
    if store_core:
        # a dense copy, stored in the same baked row/column order as the
        # buckets (the loader's `dense` field)
        dev = wt.device
        if out_perm is not None:
            wt = wt.index_select(1, _index(out_perm, dev))
        if in_perm is not None:
            wt = wt.index_select(0, _index(in_perm, dev))
        writer.add(prefix + ".core", _to_bits_bf16(wt), bf16_bits=True)


def _index(perm, device) -> torch.Tensor:
    return torch.as_tensor(perm).to(device=device, dtype=torch.int64)


def _host_array(x) -> np.ndarray:
    """A calibration vector (numpy, list or tensor on any device) as
    numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def convert_checkpoint(src_dir: str, dst_dir: str, cfg: ModelConfig,
                       bcfg: BucketConfig, family: Optional[str] = None,
                       store_core: bool = False, calib: Optional[Dict] = None,
                       fuse: bool = False, progress=print,
                       device=None) -> str:
    """Convert an HF checkpoint directory to the bucket format; returns the
    shard set's name ("buckets-<DTYPE>"). Bucketizing runs on `device`, the
    card unless named (device="cpu" runs it all on the host).

    calib: optional {"rms_m": [dim], "rms_f": [hidden]} activation
    calibration (from convert/calibrate.py collect_act_rms, or an .npz
    path): runs the whole-model BAKED relayout during conversion. The
    residual and FFN-hidden spaces are permuted by descending rms and the
    permutations absorbed into the weights (embedding columns, projection
    input rows, producer output columns, norms, lm head), so the served
    model needs no run-time permute anywhere.

    fuse: bucketize CONCATENATED q|k|v and w1|w3 projections (stored as
    attention.wqkv / feed_forward.experts.{e}.w13): one kernel launch and
    one shared selection each at serve time (LayerWeights.wqkv).
    store_core: also store each projection's dense bf16 copy (`.core`).
    """
    device = resolve_device(device)
    family = family or ("mixtral" if cfg.is_moe else "mistral")
    if family == "llama":
        family = "mistral"          # identical HF tensor names
    names = HF_NAME_MAPS[family]
    src = MultiShardReader(src_dir)
    model_tag = f"buckets-{bcfg.dtype.upper()}"
    writer = SafeTensorWriter(dst_dir, model_tag)

    pi_m = pi_f = None
    if calib is not None:
        if isinstance(calib, str):
            calib = dict(np.load(calib))
        calib = {k: _host_array(v) for k, v in calib.items()}
        pi_m = np.argsort(-calib["rms_m"]).astype(np.int32)
        if "rms_f" in calib:
            pi_f = np.argsort(-calib["rms_f"]).astype(np.int32)

    def get(name):
        return _source(src, name, device)

    def permuted(x, perm, axis=0):
        return x if perm is None else x.index_select(axis,
                                                     _index(perm, device))

    writer.add("norm", _np(permuted(get(names["norm"]), pi_m)))
    writer.add("tok_embeddings",
               _to_bits_bf16(permuted(get(names["embed"]), pi_m, axis=1)),
               bf16_bits=True)
    lm = names["lm_head"]
    out_w = get(lm if lm in src else names["embed"])   # tied embeddings
    writer.add("output", _to_bits_bf16(permuted(out_w.T, pi_m)),
               bf16_bits=True)
    del out_w

    # baked perms per projection (models/transformer.assemble_weights):
    # in_perm: what this matrix's INPUT space was permuted by;
    # out_perm: the consumer space's permutation (this matrix produces it)
    proj_perms = {"wq": (pi_m, None), "wk": (pi_m, None),
                  "wv": (pi_m, None), "wo": (None, pi_m),
                  "w1": (pi_m, pi_f), "w3": (pi_m, pi_f),
                  "w2": (pi_f, pi_m)}
    # out_perm of the fused w1|w3: pi_f within each half
    pi_13 = (None if pi_f is None else
             np.concatenate([pi_f, pi_f + cfg.hidden_dim]))

    def store(prefix, w_hf, p):
        ip, op = proj_perms[p]
        _bucketize_and_store(writer, prefix, w_hf, bcfg, store_core,
                             in_perm=ip, out_perm=op)

    for l in range(cfg.n_layers):
        progress(f"converting layer {l}/{cfg.n_layers}")
        pre = f"layers.{l}."
        writer.add(pre + "attention_norm", _np(permuted(
            get(names["attn_norm"].format(l=l)), pi_m)))
        writer.add(pre + "ffn_norm", _np(permuted(
            get(names["ffn_norm"].format(l=l)), pi_m)))
        if fuse:
            qkv = torch.cat([get(names[p].format(l=l))
                             for p in ("wq", "wk", "wv")])   # HF [out, in]
            _bucketize_and_store(writer, pre + "attention.wqkv", qkv,
                                 bcfg, store_core, in_perm=pi_m)
            del qkv
            attn_projs = ("wo",)
        else:
            attn_projs = ("wq", "wk", "wv", "wo")
        for p in attn_projs:
            store(pre + f"attention.{p}", get(names[p].format(l=l)), p)

        def store_ffn(e: int, name_of):
            pre_e = pre + f"feed_forward.experts.{e}."
            if fuse:
                w13 = torch.cat([get(name_of("w1")), get(name_of("w3"))])
                _bucketize_and_store(writer, pre_e + "w13", w13, bcfg,
                                     store_core, in_perm=pi_m,
                                     out_perm=pi_13)
                del w13
                ps = ("w2",)
            else:
                ps = ("w1", "w2", "w3")
            for p in ps:
                store(pre_e + p, get(name_of(p)), p)

        if cfg.is_moe:
            writer.add(pre + "ffn_gate", _to_bits_bf16(permuted(
                get(names["gate"].format(l=l)).T, pi_m)), bf16_bits=True)
            for e in range(cfg.n_experts):
                store_ffn(e, lambda p, e=e: names[p].format(l=l, e=e))
        else:
            store_ffn(0, lambda p: names[p].format(l=l))
    writer.save()
    src.close()

    meta = {"model": cfg.as_dict(),
            "buckets": dataclasses.asdict(bcfg),
            "fused": fuse,
            "calibrated": calib is not None}
    if calib is not None:
        # the measured activation-concentration profile predicts the
        # checkpoint's effort speedup (a flat profile streams about every
        # chunk under the tau coverage bound); the loader reports it
        def _conc(v):
            v = np.sort(np.asarray(v, np.float64))[::-1]
            return round(float(v[:len(v) // 4].sum()
                               / (v.sum() + 1e-30)), 4)
        meta["activation_profile"] = {
            "top25pct_mass_m": _conc(calib["rms_m"]),
            **({"top25pct_mass_f": _conc(calib["rms_f"])}
               if "rms_f" in calib else {}),
        }
    with open(os.path.join(dst_dir, "config.json"), "w") as f:
        json.dump(meta, f, indent=2)
    progress(f"saved {model_tag} to {dst_dir}")
    return model_tag
