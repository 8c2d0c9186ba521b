"""Per-shard execution: the port's ``shard_map``.

A table of a W-rank world holds every column as ONE ``(W·cap, ...)``
tensor; shard r is the row block ``[r·cap, (r+1)·cap)`` (core/table.py).
The reference runs a world-1 program on every shard under ``shard_map``;
here :func:`map_shards` runs a world-1 function once per rank on that
rank's views (:func:`shard`) and places each result, shard-major, into
one common-capacity output.  Every W > 1 operator goes through these
two functions; at world size 1 they hand the tensors through untouched.

In a multi-process world (ctx/context.DistributedConfig) a process
holds only its V local ranks' blocks, ``(V·cap, ...)``: :func:`span`
names those ranks, :func:`shard` takes a GLOBAL rank and finds its block
among the local ones, and :func:`map_shards` loops the local ranks only.
Per-rank host arrays (valid counts, count matrices) stay global, so a
``fn(r)`` indexes them by the global rank as before.
"""

from __future__ import annotations

import numpy as np
import torch

from . import transport


def span(w: int) -> range:
    """The global ranks of a W-rank world whose row blocks this process
    holds: all of them, unless a multi-process world of size W is
    active."""
    proc = transport.current(w)
    return range(w) if proc is None else proc.ranks


def local_world(w: int) -> int:
    """V, the row blocks this process holds of a W-rank world."""
    return len(span(w))


def local_counts(vc) -> np.ndarray:
    """This process's entries of a global per-rank host vector."""
    vc = np.asarray(vc).reshape(-1)
    sp = span(len(vc))
    return vc[sp.start:sp.stop]


def shard(x, w: int, r: int):
    """Global rank ``r``'s row block of a tensor holding this process's
    blocks (``(W·cap, ...)`` in one process): a view.  ``None`` passes
    through; at ``w == 1`` the tensor itself."""
    if x is None or w == 1:
        return x
    sp = span(w)
    cap = x.shape[0] // len(sp)
    i = r - sp.start
    return x[i * cap:(i + 1) * cap]


def _leaves(tree, out: list) -> list:
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    """``tree``'s structure (tuples, lists, named tuples) over ``it``."""
    if isinstance(tree, (tuple, list)):
        parts = [_rebuild(t, it) for t in tree]
        if isinstance(tree, list):
            return parts
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return next(it)


def map_shards(fn, w: int, cap: int | None = None):
    """Run ``fn(r)`` for every rank ``r`` of a W-rank world that this
    process holds (:func:`span`) and stack the results shard-major.

    ``fn`` returns a (nested) tuple/list of tensors and ``None``s, the
    same structure on every rank.  Each tensor leaf of rank r's result
    lands in rows ``[r·cap, r·cap + len)`` of one ``(W·cap, ...)``
    output, the rest of the block zeroed; it is copied there as soon as
    rank r finishes, so at most one rank's temporaries are alive beside
    the outputs.  A 0-dim leaf counts as one row.  ``cap`` defaults to
    the leaf's length on rank 0; a longer leaf raises.  ``None`` leaves
    stay ``None``.  At ``w == 1`` a leaf of ``cap`` rows comes back as
    the very tensor ``fn(0)`` returned."""
    skeleton = outs = None
    ranks = span(w)
    v = len(ranks)
    for r in ranks:
        res = fn(r)
        leaves = [x.reshape(1) if x is not None and x.dim() == 0 else x
                  for x in _leaves(res, [])]
        if outs is None:
            skeleton = _rebuild(res, iter([None] * len(leaves)))
            outs = [x if x is None or (w == 1 and cap in (None, x.shape[0]))
                    else torch.empty(
                        (v * (x.shape[0] if cap is None else cap),)
                        + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
                    for x in leaves]
        del res
        for out, x in zip(outs, leaves):
            if out is None or out is x:
                continue
            c = out.shape[0] // v
            if x.shape[0] > c:
                raise ValueError(f"rank {r} returned {x.shape[0]} rows for "
                                 f"a {c}-row shard")
            i = r - ranks.start
            out[i * c:i * c + x.shape[0]] = x
            out[i * c + x.shape[0]:(i + 1) * c] = 0
        del leaves
    return _rebuild(skeleton, iter(outs))
