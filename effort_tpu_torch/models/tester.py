"""Golden-state regression tester (the JAX package's models/tester.py).

Run a reduced-layer model over a fixed token sequence, record intermediate
activations (post-layer residual stream h per (token, layer) plus final
logits per token) to a versioned safetensors file; later runs compare each
recorded vector by cosine similarity >= threshold, counting residual-stream
"drift" separately from hard failures.

The same VERSION, file names and keys as the JAX package's tester, so a
golden file written by either package verifies in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence

import numpy as np

from effort_tpu_torch.config import ModelConfig
from effort_tpu_torch.models.transformer import (ModelWeights, forward_token,
                                                 make_kv_cache,
                                                 resolve_device)
from effort_tpu_torch.runtime.safetensors_io import (SafeTensorReader,
                                                     SafeTensorWriter)

VERSION = "1.0"


@dataclasses.dataclass
class VerifyReport:
    passed: bool
    failures: List[str]
    drift: int                 # residual-stream keys below threshold
    compared: int

    def __str__(self):
        s = "PASS" if self.passed else "FAIL"
        return (f"golden-state {s}: {self.compared} compared, "
                f"{self.drift} drift, {len(self.failures)} failures"
                + (f" ({self.failures[:5]})" if self.failures else ""))


def capture_states(w: ModelWeights, cfg: ModelConfig,
                   token_ids: Sequence[int], effort: float = 1.0,
                   impl: str = "reference",
                   device=None) -> Dict[str, np.ndarray]:
    """{"h_tok{t}_lay{l}": [dim], "logits_tok{t}": [vocab]} f32 over
    token_ids, one eager forward_token(collect_h=True) a token on `device`
    (the card unless named). impl: the port's route ("reference" reads
    every weight, as the JAX package's default "jnp")."""
    device = resolve_device(device)
    w = w.to(device)
    k_cache, v_cache = make_kv_cache(cfg, device)
    states: Dict[str, np.ndarray] = {}
    for t, tok in enumerate(token_ids):
        logits, h_layers = forward_token(
            w, cfg, int(tok), t, k_cache, v_cache, effort=effort, impl=impl,
            collect_h=True)
        h = h_layers.float().cpu().numpy()
        for l in range(cfg.n_layers):
            states[f"h_tok{t}_lay{l}"] = h[l]
        states[f"logits_tok{t}"] = logits.float().cpu().numpy()
    return states


def save_states(path_dir: str, states: Dict[str, np.ndarray],
                tag: str = "golden") -> str:
    name = f"tests-{VERSION}-{tag}"
    wtr = SafeTensorWriter(path_dir, name)
    for k, v in states.items():
        wtr.add(k, np.asarray(v).astype(np.float32))
    wtr.save()
    return name


def verify_states(path_dir: str, states: Dict[str, np.ndarray],
                  tag: str = "golden", threshold: float = 0.99
                  ) -> VerifyReport:
    name = f"tests-{VERSION}-{tag}"
    fn = None
    for f in sorted(os.listdir(path_dir)):
        if f.startswith(name) and f.endswith(".safetensors"):
            fn = os.path.join(path_dir, f)
            break
    if fn is None:
        raise FileNotFoundError(f"no golden file {name} in {path_dir}")
    r = SafeTensorReader(fn)
    failures, drift, compared = [], 0, 0
    for key in r.keys():
        if key not in states:
            failures.append(f"missing:{key}")
            continue
        a = np.array(r[key], np.float64).ravel()
        b = np.asarray(states[key], np.float64).ravel()
        n = np.linalg.norm(a) * np.linalg.norm(b)
        cs = float(a @ b / n) if n else 1.0
        compared += 1
        if cs < threshold:
            # residual-stream keys accumulate drift (tolerated, counted);
            # anything else is a hard failure
            if key.startswith("h_"):
                drift += 1
            else:
                failures.append(f"{key}:cos={cs:.4f}")
    r.close()
    return VerifyReport(passed=not failures, failures=failures,
                        drift=drift, compared=compared)
