"""Parity of the row hash that routes every hash shuffle: cylon_tpu_torch's
``ops/hashing`` against cylon_tpu's, bit for bit, on every dtype the
port's columns hold, with nulls, 1-3 key columns and the float edge
cases (signed zeros, NaNs, infinities, subnormals, values that collide
only after the float64 -> float32 downcast), and ``partition_targets`` /
``partition_of`` at world sizes 1, 2, 3, 4, 6 and 8 (the mask for powers
of two, the unsigned modulo otherwise).  Inputs come from a numpy seed;
the tolerance is bit equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu.ops import hashing as rh
from cylon_tpu_torch.ops import hashing as ph

N = 2048
WORLDS = (1, 2, 3, 4, 6, 8)


def _floats(dtype, rng):
    """Normal values plus every edge case the canonicalization touches."""
    x = rng.normal(size=N).astype(dtype)
    special = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                        1e-40, -1e-40, 1e-45, -1e-45, 1.17549e-38,
                        -1.17549e-38, np.finfo(np.float32).max])
    if dtype == np.float64:
        tiny = 2.0 ** -126
        special = np.concatenate([special, [
            1e-310, -1e-310, 5e-324, 1e300, -1e300, 2.0 ** -1022,
            tiny - 2.0 ** -151, np.nextafter(tiny - 2.0 ** -151, 0),
            tiny - 2.0 ** -150, -(tiny - 2.0 ** -149),
            # distinct in float64, one value once downcast
            1.0 + 2.0 ** -30, 1.0 + 2.0 ** -40, 1.0]])
    x[:len(special)] = special.astype(dtype)
    return x


def _column(kind, rng):
    if kind == "int64":
        return rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64)
    if kind == "int64_narrow":
        return rng.integers(-2**31, 2**31, N).astype(np.int64)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, N).astype(np.int32)
    if kind == "int16":
        return rng.integers(-2**15, 2**15, N).astype(np.int16)
    if kind == "int8":
        return rng.integers(-128, 128, N).astype(np.int8)
    if kind == "uint8":
        return rng.integers(0, 256, N).astype(np.uint8)
    if kind == "uint32":
        return rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    if kind == "u32_in_int64":     # the port's unsigned operand form
        return rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.int64)
    if kind == "uint64":
        return rng.integers(0, 2**64, N, dtype=np.uint64)
    if kind == "float64":
        return _floats(np.float64, rng)
    if kind == "float32":
        return _floats(np.float32, rng)
    if kind == "bool":
        return rng.random(N) < 0.5
    raise ValueError(kind)


KINDS = ("int64", "int64_narrow", "int32", "int16", "int8", "uint8",
         "uint32", "u32_in_int64", "uint64", "float64", "float32", "bool")


def _both(cols, valids=None):
    ref = np.asarray(rh.hash_rows(
        [jnp.asarray(c) for c in cols],
        None if valids is None else [None if v is None else jnp.asarray(v)
                                     for v in valids])).astype(np.int64)
    port = ph.hash_rows(
        [torch.from_numpy(c) for c in cols],
        None if valids is None else [None if v is None
                                     else torch.from_numpy(v)
                                     for v in valids])
    assert port.dtype == torch.int64
    return ref, port.numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_hash_rows_one_key(kind):
    col = _column(kind, np.random.default_rng(KINDS.index(kind)))
    ref, port = _both([col])
    np.testing.assert_array_equal(port, ref)
    assert port.min() >= 0 and port.max() < 2**32


@pytest.mark.parametrize("kind", ("int64", "int32", "float64", "bool"))
def test_hash_rows_nullable(kind):
    rng = np.random.default_rng(11)
    col = _column(kind, rng)
    valid = rng.random(N) > 0.2
    ref, port = _both([col], [valid])
    np.testing.assert_array_equal(port, ref)
    # a null hashes as one fixed lane whatever its payload
    other = col.copy()
    other[~valid] = other[::-1][~valid]
    np.testing.assert_array_equal(_both([other], [valid])[1], port)


@pytest.mark.parametrize("kinds", [("int64", "int32"),
                                   ("float64", "int16", "bool"),
                                   ("uint32", "float32", "int64")])
def test_hash_rows_multi_key(kinds):
    rng = np.random.default_rng(len(kinds))
    cols = [_column(k, rng) for k in kinds]
    valids = [rng.random(N) > 0.1 if i == 1 else None
              for i in range(len(cols))]
    ref, port = _both(cols, valids)
    np.testing.assert_array_equal(port, ref)
    ref, port = _both(cols)
    np.testing.assert_array_equal(port, ref)


def test_downcast_collisions_and_canonical_zero():
    # equal keys hash equal: -0.0 == +0.0, every NaN one NaN, float64
    # values one float32 apart collapse; 2^-1022 flushes to +0.0
    x = np.array([0.0, -0.0, np.nan, -np.nan, 1.0, 1.0 + 2.0 ** -40,
                  2.0 ** -1022, 1e-310])
    _, port = _both([x])
    assert port[0] == port[1] == port[6] == port[7]
    assert port[2] == port[3]
    assert port[4] == port[5]


@pytest.mark.parametrize("w", WORLDS)
def test_partition_targets(w):
    col = _column("int64", np.random.default_rng(w))
    ref_h, port_h = _both([col])
    ref = np.asarray(rh.partition_targets(jnp.asarray(ref_h, jnp.uint32), w))
    port = ph.partition_targets(torch.from_numpy(port_h), w)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    assert set(np.unique(ref)) <= set(range(w))
    for h in ref_h[:64]:
        assert ph.partition_of(h, w) == rh.partition_of(h, w)
