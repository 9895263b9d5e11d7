"""Operating-point auto-tuner: choose {dtype, percent_load, effort} for a
target agreement floor or a device-memory budget (the JAX package's
models/autotune.py).

Every candidate point is scored by decode speed and by teacher-forced
argmax agreement against the FULL bf16 checkpoint (the reference's own
control protocol), so the chosen point's quality cost includes
quantization and truncation damage, not just the effort knob.

Two entry styles:
  choose_operating_point(points, ...)  pure selection over measured points
      (precomputed operating points or auto_tune's output); no device.
  auto_tune(ckpt_dir, ...)             measure candidate points on the
      device, then choose. `python -m effort_tpu_torch autotune` wraps it.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["expand_rows", "choose_operating_point", "auto_tune"]


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# pure selection
# --------------------------------------------------------------------------

def expand_rows(rows: Sequence[Dict]) -> List[Dict]:
    """operating-points rows (per-config dicts holding per-effort fields
    toks_per_s_<tag> / agreement_vs_full_<tag>) -> flat point dicts
    {config, effort, toks_per_s, agreement, speedup}."""
    points = []
    for r in rows:
        for key, tps in r.items():
            if not key.startswith("toks_per_s_"):
                continue
            tag = key[len("toks_per_s_"):]
            agr = r.get(f"agreement_vs_full_{tag}",
                        r.get(f"agreement_{tag}"))
            points.append({
                "config": r.get("config", "?"),
                "effort": int(tag) / 100.0,
                "toks_per_s": tps,
                "agreement": agr,
                "speedup": r.get(f"speedup_vs_full_dense_{tag}",
                                 r.get(f"speedup_vs_dense_{tag}")),
            })
    return points


def choose_operating_point(points: Sequence[Dict],
                           target_agreement: Optional[float] = None
                           ) -> Optional[Dict]:
    """Fastest measured point whose agreement meets the floor.

    Points without an agreement measurement only qualify when no floor is
    given. Returns None when nothing qualifies (the caller falls back to
    the full bf16 effort=1.0 point)."""
    ok = []
    for p in points:
        if target_agreement is not None:
            if p.get("agreement") is None \
                    or p["agreement"] < target_agreement:
                continue
        if p.get("toks_per_s") is None:
            continue
        ok.append(p)
    return max(ok, key=lambda p: p["toks_per_s"]) if ok else None


# --------------------------------------------------------------------------
# measured tuning
# --------------------------------------------------------------------------

def _ladder(ckpt_dir: str, hbm_budget_bytes: Optional[int],
            cfg, efforts: Sequence[float]) -> List[Dict]:
    """Candidate configs, cheapest-expected-quality-cost last. Each is
    {dtype, ckpt, percent_load}; efforts multiply inside measurement. A
    memory budget filters candidates analytically (the reference's RAM
    probe) before anything is loaded. Quantized checkpoints are siblings
    of the bf16 one: <parent>/ckpt_int8, <parent>/ckpt_int4."""
    from effort_tpu_torch.config import BucketConfig
    from effort_tpu_torch.models.weights import model_weight_bytes

    cands = []
    for dt in ("int4", "int8", "bf16"):
        ck = (ckpt_dir if dt == "bf16"
              else os.path.join(os.path.dirname(ckpt_dir), f"ckpt_{dt}"))
        if dt != "bf16" and not os.path.exists(
                os.path.join(ck, "config.json")):
            continue
        for pl in (11 / 16, 1.0):
            if hbm_budget_bytes is not None:
                bcfg = BucketConfig(bucket_size=1, chunk_rows=128,
                                    dtype=dt)
                if model_weight_bytes(cfg, bcfg, pl) > hbm_budget_bytes:
                    continue
            cands.append({"dtype": dt, "ckpt": ck, "percent_load": pl})
    return cands


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def auto_tune(ckpt_dir: str, target_agreement: Optional[float] = 0.8,
              hbm_budget_bytes: Optional[int] = None,
              hold: Optional[Sequence[int]] = None,
              efforts: Sequence[float] = (0.5, 0.35, 0.25),
              progress=_stderr, device=None) -> Dict:
    """Measure the candidate ladder on `device` (the card unless named)
    and choose.

    hbm_budget_bytes: the ladder's budget filter, and load_bucketized's
    (on the CPU it has no card memory to ask). hold: holdout token ids for
    the agreement control (>= 500 for the reference-scale protocol);
    default <ckpt parent>/corpus.npy at 98% of its length, 500 tokens.
    progress: one line a candidate (stderr by default, so stdout stays
    the caller's).
    Returns {"chosen": point|None, "points": [...], "dense_toks_per_s",
    "target_agreement", "hbm_budget_bytes"}."""
    import numpy as np
    from effort_tpu_torch.eval.harness import (decode_speed_sweep,
                                               tf_agreement_sweep,
                                               tf_control_preds)
    from effort_tpu_torch.models.generate import Engine
    from effort_tpu_torch.models.transformer import resolve_device
    from effort_tpu_torch.models.weights import (attach_dense,
                                                 load_bucketized,
                                                 truncate_model)

    device = resolve_device(device)
    if hold is None:
        cp = os.path.join(os.path.dirname(os.path.abspath(ckpt_dir)),
                          "corpus.npy")
        if os.path.exists(cp):
            corpus = np.load(cp)
            split = int(len(corpus) * 0.98)
            hold = corpus[split:split + 500].astype(int).tolist()

    def load(ck):
        return load_bucketized(ck, load_dense=False, device=device,
                               hbm_budget_bytes=hbm_budget_bytes)

    # full bf16 reference: dense speed baseline + agreement control
    w, cfg, _ = load(ckpt_dir)
    w = attach_dense(w)
    _sync(device)
    sp = decode_speed_sweep(w, cfg, efforts=(1.0,), include_dense=True,
                            device=device)
    dense_ref = sp["dense_toks_per_s"]
    control = None
    if hold is not None:
        eng = Engine(w, cfg, impl="auto", dynamic_effort=True, eos_id=-1,
                     device=device)
        control = tf_control_preds(eng, hold)
        del eng
    del w

    points = []
    out = {"dense_toks_per_s": dense_ref, "points": points,
           "target_agreement": target_agreement,
           "hbm_budget_bytes": hbm_budget_bytes}
    for cand in _ladder(ckpt_dir, hbm_budget_bytes, cfg, efforts):
        t0 = time.time()
        wv, cfgv, _ = load(cand["ckpt"])
        if cand["percent_load"] < 1.0:
            wv = truncate_model(wv, cand["percent_load"])
        _sync(device)
        spv = decode_speed_sweep(wv, cfgv, efforts=efforts,
                                 include_dense=False, device=device)
        agr = {}
        if control is not None:
            engv = Engine(wv, cfgv, impl="auto", dynamic_effort=True,
                          eos_id=-1, device=device)
            agr = tf_agreement_sweep(engv, hold, efforts=efforts,
                                     control=control)
            del engv
        name = (f"{cand['dtype']} percent_load="
                f"{cand['percent_load']:.3f}")
        for e in efforts:
            tag = int(e * 100)
            points.append({
                "config": name, "effort": e,
                "toks_per_s": spv[f"toks_per_s_{tag}"],
                "speedup": round(spv[f"toks_per_s_{tag}"] / dense_ref, 3),
                "agreement": (round(agr[e], 3) if e in agr else None),
            })
        progress(f"[autotune] {name}: "
                 + " ".join(f"{p['effort']:.2f}->"
                            f"{p['speedup']}x/{p['agreement']}"
                            for p in points[-len(efforts):])
                 + f" ({time.time() - t0:.0f}s)")
        del wv

    out["chosen"] = choose_operating_point(points, target_agreement)
    return out
