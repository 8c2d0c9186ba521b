"""Per-shard execution: the port's ``shard_map``.

A table of a W-rank world holds every column as ONE ``(W·cap, ...)``
tensor; shard r is the row block ``[r·cap, (r+1)·cap)`` (core/table.py).
The reference runs a world-1 program on every shard under ``shard_map``;
here :func:`map_shards` runs a world-1 function once per rank on that
rank's views (:func:`shard`) and places each result, shard-major, into
one common-capacity output.  Every W > 1 operator goes through these
two functions; at world size 1 they hand the tensors through untouched.
"""

from __future__ import annotations

import torch


def shard(x, w: int, r: int):
    """Rank ``r``'s row block of a ``(W·cap, ...)`` tensor: a view.
    ``None`` passes through; at ``w == 1`` the tensor itself."""
    if x is None or w == 1:
        return x
    cap = x.shape[0] // w
    return x[r * cap:(r + 1) * cap]


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
    """Run ``fn(r)`` for every rank ``r`` of a W-rank world and stack the
    results shard-major.

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
    for r in range(w):
        res = fn(r)
        leaves = [x.reshape(1) if x is not None and x.dim() == 0 else x
                  for x in _leaves(res, [])]
        if outs is None:
            skeleton = _rebuild(res, iter([None] * len(leaves)))
            outs = [x if x is None or (w == 1 and cap in (None, x.shape[0]))
                    else torch.empty(
                        (w * (x.shape[0] if cap is None else cap),)
                        + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
                    for x in leaves]
        del res
        for out, x in zip(outs, leaves):
            if out is None or out is x:
                continue
            c = out.shape[0] // w
            if x.shape[0] > c:
                raise ValueError(f"rank {r} returned {x.shape[0]} rows for "
                                 f"a {c}-row shard")
            out[r * c:r * c + x.shape[0]] = x
            out[r * c + x.shape[0]:(r + 1) * c] = 0
        del leaves
    return _rebuild(skeleton, iter(outs))
