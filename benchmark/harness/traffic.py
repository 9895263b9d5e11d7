"""The one traffic generator: every mix is a data file of its parameters.

Lengths are drawn log-normally around a median and clipped to a range
({"median", "sigma", "low", "high"}). The set of sizes comes from the
mix's own `sizes_seed`, so every run draws the same set; the run's
--seed orders it and draws the token ids, so two seeds do the same work
in another order on other tokens.

Two shapes of traffic:
  - sessions (a mix with "first_prompt", "later_prompt" and "reply"):
    conversations of turns, each a prompt and a reply length; a
    conversation ends when its next turn would not fit the positions
    (the padded prompt plus the reply, as a session counts them);
  - requests (a mix with "prompt" and "reply"): independent prompts and
    reply lengths, the padded prompt plus the reply within the positions,
    one block of `block` requests that repeats, each repeat in its own
    order from the seed: any stretch of the run sees about the same sizes
    whatever the seed. The block's lengths are the distribution's
    quantiles at (i + 1/2) / block, prompts and replies paired by a fixed
    shuffle from `sizes_seed`.
"""

from __future__ import annotations

import statistics

import numpy as np


def draw(rng: np.random.Generator, spec: dict, n: int = None):
    """Log-normal lengths around spec["median"], clipped to [low, high]."""
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.round(x), spec["low"], spec["high"]).astype(int)


def strata(spec: dict, n: int) -> list:
    """The n lengths at the quantiles (i + 1/2) / n of the clipped
    log-normal."""
    z = statistics.NormalDist()
    return [int(np.clip(np.round(spec["median"] * np.exp(
        spec["sigma"] * z.inv_cdf((i + 0.5) / n))), spec["low"],
        spec["high"])) for i in range(n)]


def padded(n: int, pad_to: int) -> int:
    return max(pad_to, -(-n // pad_to) * pad_to)


def sessions(mix: dict, max_pos: int) -> list:
    """The mix's fixed set of conversations: a list of lists of (prompt
    length, reply length)."""
    rng = np.random.default_rng(mix["sizes_seed"])
    pad = mix["pad_to"]
    out = []
    for _ in range(mix["pool"]):
        turns, pos = [], 0
        spec = mix["first_prompt"]
        while True:
            p, r = int(draw(rng, spec)), int(draw(rng, mix["reply"]))
            if pos + padded(p, pad) + r > max_pos:
                break
            turns.append((p, r))
            pos += p + r
            spec = mix["later_prompt"]
        out.append(turns)
    return out


def requests(mix: dict, max_pos: int) -> list:
    """The mix's fixed block of requests: a list of (prompt length, reply
    length)."""
    n = mix["block"]
    rng = np.random.default_rng(mix["sizes_seed"])
    replies = strata(mix["reply"], n)
    out = [(p, replies[j]) for p, j in zip(strata(mix["prompt"], n),
                                           rng.permutation(n))]
    if any(padded(p, mix["pad_to"]) + r > max_pos for p, r in out):
        raise ValueError("a request of the block exceeds the positions")
    return out


class Plan:
    """One run's traffic: the fixed set in the seed's order, and token ids
    from the seed, uniform in [id_low, vocab)."""

    def __init__(self, mix: dict, seed: int, vocab: int, max_pos: int):
        self.mix = mix
        self.rng = np.random.default_rng(int(seed))
        self.vocab = vocab
        if "first_prompt" in mix:
            base = sessions(mix, max_pos)
            self.items = [base[i] for i in self.rng.permutation(len(base))]
        else:
            base = requests(mix, max_pos)
            self.items = [base[i] for _ in range(mix["repeats"])
                          for i in self.rng.permutation(len(base))]

    def ids(self, n: int) -> list:
        return self.rng.integers(self.mix["id_low"], self.vocab,
                                 n).tolist()


def quartiles(xs) -> dict:
    """Count, quartiles and range of a list of lengths (the report of
    what a run drew)."""
    if not len(xs):
        return {"n": 0}
    q = np.percentile(np.asarray(xs), [0, 25, 50, 75, 100])
    return {"n": len(xs), "min": int(q[0]), "q1": float(q[1]),
            "median": float(q[2]), "q3": float(q[3]), "max": int(q[4])}
