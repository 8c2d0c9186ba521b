"""Misra-Gries top-K frequency sketch (a copy of ``cylon_tpu/obs/sketch.py``,
which imports no JAX; the port keeps its own copy).

The skew split's detector (relational/skew.py) needs "which keys are hot
and how hot" from a bounded sample of join keys without materializing a
full frequency table.  Misra-Gries is the classic deterministic answer:
``k`` tracked counters over a stream of ``n`` (weighted) updates
guarantee, for every tracked value,

    true_count - n/(k+1)  <=  estimate  <=  true_count

and every value whose true count exceeds ``n/(k+1)`` IS tracked — no
genuinely heavy key can be missed.

Host-side and numpy-only (updates pre-aggregate through ``np.unique``,
so a 4096-row sample is one vectorized pass plus O(distinct) dict work).
The same weighted stream gives the same counters, in the same order, as
the reference's sketch (tests/test_torch_skew.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MisraGries"]


class MisraGries:
    """Weighted Misra-Gries sketch with ``k`` counters.

    ``update(values[, weights])`` absorbs a batch; ``items()`` returns
    ``[(value, est_count)]`` sorted heaviest-first; ``error_bound``
    is the worst-case undercount of any estimate (total decremented
    weight — at most ``n / (k + 1)``)."""

    __slots__ = ("k", "n", "counters", "_dec")

    def __init__(self, k: int = 16):
        if k < 1:
            from ..status import InvalidError
            raise InvalidError(f"MisraGries needs k >= 1, got {k}")
        self.k = int(k)
        self.n = 0.0          # total absorbed weight
        self.counters: dict = {}
        self._dec = 0.0       # total weight removed by decrements

    def update(self, values, weights=None) -> None:
        """Absorb a batch of values (numpy array of a hashable dtype),
        each optionally carrying a weight (default 1.0 — the profiler
        passes per-shard sample weights so unequal shards pool fairly)."""
        values = np.asarray(values)
        if values.size == 0:
            return
        if weights is None:
            uniq, cnt = np.unique(values, return_counts=True)
            pairs = zip(uniq.tolist(), cnt.tolist())
        else:
            weights = np.asarray(weights, np.float64)
            uniq, inv = np.unique(values, return_inverse=True)
            wsum = np.zeros(len(uniq), np.float64)
            np.add.at(wsum, inv, weights)
            pairs = zip(uniq.tolist(), wsum.tolist())
        for v, c in pairs:
            self._add(v, float(c))

    def _add(self, v, c: float) -> None:
        self.n += c
        cur = self.counters.get(v)
        if cur is not None:
            self.counters[v] = cur + c
            return
        if len(self.counters) < self.k:
            self.counters[v] = c
            return
        # weighted decrement: drop min(smallest counter, c) from every
        # counter AND from c; zeroed counters vacate slots the remainder
        # of c may claim — the per-item MG semantics, batched.  Each
        # round removes d from k counters plus d of the incoming weight,
        # so the summed d (tracked in _dec) stays <= n/(k+1).
        while c > 0:
            d = min(min(self.counters.values()), c)
            self._dec += d
            for key in list(self.counters):
                nv = self.counters[key] - d
                if nv <= 0:
                    del self.counters[key]
                else:
                    self.counters[key] = nv
            c -= d
            if c > 0 and len(self.counters) < self.k:
                self.counters[v] = c
                return

    @property
    def error_bound(self) -> float:
        """Worst-case undercount of any estimate: the total decremented
        weight (itself bounded by n / (k + 1))."""
        return min(self._dec, self.n / (self.k + 1))

    def items(self) -> list[tuple]:
        """``[(value, est_count)]``, heaviest first."""
        return sorted(self.counters.items(), key=lambda kv: -kv[1])

    def shares(self) -> list[tuple]:
        """``[(value, est_share, err_share)]`` heaviest first —
        ``est_share`` is the estimated fraction of the absorbed weight,
        ``err_share`` the worst-case undercount as a fraction."""
        if self.n <= 0:
            return []
        err = self.error_bound / self.n
        return [(v, c / self.n, err) for v, c in self.items()]
