"""The one traffic generator: every mix is a data file of parameters
(``perfbench/traffic/<mix>.json``) that this module reads.

Sizes are stratified: block b of ``block`` draws takes the distribution's
quantiles at (i + v_b) / block, i = 0 .. block - 1, shuffled by the
seed, with v_b the base-2 radical inverse of b + 1 (1/2, 1/4, 3/4, 1/8,
...).  So every seed sends the same blocks, each in another order, and a
window's mix of sizes hardly depends on the seed; and block after block
refines the grid, so the draws reach ever further into the tail
(the 0.996 quantile by the 15th block, the 0.998 by the 31st).

A length is ``{"dist": "lognormal", "median": m, "sigma": s, "min": lo,
"max": hi}`` (rounded, then clipped) or ``{"dist": "fixed", "value": n}``.
A mix is a closed loop of ``clients``, each sending its next request
when its last one finished.  ``"start": "stationary"`` gives the first
request of each client the output length still to come of a request met
at a random time in the steady state (the residual, P(R = r) = P(L >= r)
/ E[L]), so that the clients do not all start a fresh request at once.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

_N = NormalDist()


def radical_inverse(k: int) -> float:
    """Base-2 van der Corput: 1 -> 1/2, 2 -> 1/4, 3 -> 3/4, 4 -> 1/8."""
    v, f = 0.0, 0.5
    while k:
        v += f * (k & 1)
        k >>= 1
        f /= 2
    return v


def quantiles(spec: Dict, n: int, offset: float = 0.5) -> np.ndarray:
    """The n stratified values of a length distribution at (i + offset)
    / n, sorted."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = np.array([_N.inv_cdf((i + offset) / n) for i in range(n)])
    vals = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def tail(spec: Dict) -> np.ndarray:
    """P(L >= r) for r = 0 .. max of a length as ``quantiles`` rounds
    and clips it."""
    r = np.arange(spec["max"] + 1)
    if spec["dist"] == "fixed":
        return (r <= int(spec["value"])).astype(np.float64)
    z = (np.log(np.maximum(r - 0.5, 1e-9) / spec["median"])
         / spec["sigma"])
    p = 1.0 - np.array([_N.cdf(float(x)) for x in z])
    p[r <= spec["min"]] = 1.0
    return p


def residuals(spec: Dict, n: int) -> np.ndarray:
    """The n stratified values, sorted, of the output still to come of
    a request met at a random time in the steady state (at least 1)."""
    w = tail(spec)[1:]
    cdf = np.cumsum(w) / w.sum()
    u = (np.arange(n) + 0.5) / n
    return 1 + np.searchsorted(cdf, u).astype(np.int64)


def stream(spec: Dict, n: int, rng: np.random.Generator) -> Iterator:
    """Endless draws, block after block, each shuffled afresh."""
    b = 0
    while True:
        b += 1
        for v in rng.permutation(quantiles(spec, n, radical_inverse(b))):
            yield int(v)


class Requests:
    """Requests of one serving mix: (prompt token ids, output tokens),
    in order, from the seed."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        n = int(mix.get("block", 16))
        self.rng = np.random.default_rng(seed)
        self.vocab = vocab
        self._prompt = stream(mix["prompt"], n, self.rng)
        self._output = stream(mix["output"], n, self.rng)
        self._first: List[int] = []
        if mix.get("start") == "stationary":
            self._first = list(self.rng.permutation(
                residuals(mix["output"], int(mix["clients"]))))

    def next(self) -> Tuple[np.ndarray, int]:
        L = next(self._prompt)
        new = int(self._first.pop()) if self._first else next(self._output)
        ids = self.rng.integers(0, self.vocab, L, dtype=np.int64)
        return ids.astype(np.int32), new
