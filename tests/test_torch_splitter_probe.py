"""Parity of the splitter probe (K2): the port's ``count_ge_splitters`` on a
CPU tensor (its plain version) against cylon_tpu's Pallas kernel run in
interpret mode and against the reference's ``rows_ge_splitters`` sum (the
only reference for float64 keys, whose ``'f'`` operand the Pallas kernel
does not take).

Inputs are made with numpy from a seed and packed into key operands by
each package's own ``key_operands``, so the operand images (the port's
int64-held u32 lanes against the reference's uint32 lanes) are part of
what is held equal.  Counts are integers: bit-equal, no tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu.ops import pack as rpack
from cylon_tpu.ops import pallas_probe
from cylon_tpu_torch.ops import pack as ppack
from cylon_tpu_torch.ops import splitter_probe as sp

PAD_L = 4


def _key_column(case, cap, rng):
    """(data, validity|None, narrow) of one key column."""
    if case == "narrow":
        return rng.integers(0, 600, cap).astype(np.int64), None, True
    if case == "wide":
        # (hi int32, lo u32) pairs: heavy hi ties force the eq chain, and
        # lo values sit on both sides of the 2^31 boundary
        hi = rng.integers(-3, 3, cap).astype(np.int64)
        lo = rng.integers(0, 1 << 32, cap, dtype=np.uint64).astype(np.int64)
        lo[:64] = 0x80000000
        lo[64:128] = 0x7FFFFFFF
        return (hi << 32) | lo, None, False
    if case == "nullable":
        d = rng.integers(-50, 50, cap).astype(np.int32)
        return d, rng.random(cap) > 0.2, False
    if case == "float32":
        d = rng.normal(size=cap).astype(np.float32)
        d[:16] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf] + [1.5] * 10
        return d, None, False
    if case == "float64":
        d = rng.normal(size=cap)
        d[:16] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf] + [1.5] * 10
        return d, None, False
    raise ValueError(case)


def _operands(case, cap, n_split, seed):
    """Reference (jax) and port (torch) key operands of the same column,
    and splitters drawn from the rows plus repeated +inf sentinel slots."""
    rng = np.random.default_rng(seed)
    data, valid, narrow = _key_column(case, cap, rng)
    live = cap - 37
    mask = np.arange(cap) < live
    need_nf = (valid is not None,)
    r_ko = rpack.key_operands(
        [jnp.asarray(data)], [None if valid is None else jnp.asarray(valid)],
        row_mask=jnp.asarray(mask), pad_key=PAD_L, need_null_flags=need_nf,
        narrow32=(narrow,))
    p_ko = ppack.key_operands(
        [torch.from_numpy(data)],
        [None if valid is None else torch.from_numpy(valid)],
        row_mask=torch.from_numpy(mask), pad_key=PAD_L,
        need_null_flags=need_nf, narrow32=(narrow,))
    # splitters: rows of the table (so some rows equal a splitter), in
    # sorted order as the pipeline makes them, then duplicates of the
    # sentinel slot (liveness = pad key, other operands 0)
    n_sent = min(2, n_split - 1)
    sel = np.sort(rng.integers(0, cap, n_split - n_sent))
    r_sops, p_sops = [], []
    for j, (ro, po) in enumerate(zip(r_ko.ops, p_ko.ops)):
        sent = PAD_L if j == 0 else 0
        rv = np.concatenate([np.asarray(ro)[sel],
                             np.full(n_sent, sent, np.asarray(ro).dtype)])
        pv = np.concatenate([po.numpy()[sel],
                             np.full(n_sent, sent, po.numpy().dtype)])
        r_sops.append(jnp.asarray(rv))
        p_sops.append(torch.from_numpy(pv))
    return r_ko, tuple(r_sops), p_ko, tuple(p_sops)


@pytest.mark.parametrize("cap", [1024, 4096])
@pytest.mark.parametrize("n_split", [1, 5, 128])
@pytest.mark.parametrize("case", ["narrow", "wide", "nullable", "float32",
                                  "float64"])
def test_count_ge_splitters_bit_equal(case, n_split, cap):
    r_ko, r_sops, p_ko, p_sops = _operands(case, cap, n_split,
                                           seed=n_split * 7 + cap)
    assert r_ko.kinds == p_ko.kinds
    matrix = np.asarray(jnp.sum(rpack.rows_ge_splitters(r_ko, r_sops),
                                axis=1, dtype=jnp.int32))
    if "f" in r_ko.kinds:
        # the reference keeps XLA for f64 operands: its matrix is the oracle
        assert not pallas_probe.supported(cap, n_split, r_ko.kinds)
        kernel = matrix
    else:
        assert pallas_probe.supported(cap, n_split, r_ko.kinds)
        kernel = np.asarray(pallas_probe.count_ge_splitters(
            r_ko.ops, r_sops, interpret=True))
        np.testing.assert_array_equal(kernel, matrix)
    sp.reset_counts()
    got = sp.count_ge_splitters(p_ko.ops, p_sops)
    assert got.dtype == torch.int32 and got.shape == (cap,)
    assert sp.COUNTS["launches"] == 0          # CPU tensor: plain version
    np.testing.assert_array_equal(got.numpy(), kernel)
    np.testing.assert_array_equal(
        sp.count_ge_splitters_plain(p_ko.ops, p_sops).numpy(), kernel)
    # the port's rows_ge_splitters matrix itself, not just its row sums
    np.testing.assert_array_equal(
        ppack.rows_ge_splitters(p_ko, p_sops).numpy(),
        np.asarray(rpack.rows_ge_splitters(r_ko, r_sops)))


@pytest.mark.parametrize("dtypes,need_nf,narrow", [
    (("int64",), (False,), (True,)),
    (("int64",), (False,), (False,)),
    (("int32", "float64"), (True, False), (False, False)),
    (("float32", "bool", "uint32"), (False, True, False),
     (False, False, False)),
    (("uint64", "int16"), (True, True), (False, False)),
])
def test_key_operand_kinds(dtypes, need_nf, narrow):
    """The kinds the port's key_operands builds equal the reference's
    static kinds for the same key structure, and both size the sort
    operands alike."""
    n = 16
    rng = np.random.default_rng(1)
    datas = [torch.from_numpy(rng.integers(0, 2, n).astype(dt))
             for dt in dtypes]
    valids = [torch.from_numpy(rng.random(n) > 0.5) if nf else None
              for nf in need_nf]
    ko = ppack.key_operands(datas, valids, row_mask=torch.ones(n, dtype=bool),
                            need_null_flags=need_nf, narrow32=narrow)
    assert ko.kinds == rpack.key_operand_kinds(dtypes, need_nf, narrow)
    assert ppack.sort_operand_nbytes(dtypes, need_nf, narrow, 1000) == \
        rpack.sort_operand_nbytes(dtypes, need_nf, narrow, 1000)


def test_wrapper_refuses_mismatched_operands():
    """On a non-CPU, non-CUDA device the wrapper raises rather than pick a
    path; the kernel's input checks reject mixed operand types."""
    ops = (torch.zeros(1024, dtype=torch.int32, device="meta"),)
    with pytest.raises(sp.InvalidError):
        sp.count_ge_splitters(ops, ops)
    with pytest.raises(sp.InvalidError, match="same type"):
        sp.plan((torch.zeros(1024, dtype=torch.int32),),
                (torch.zeros(3, dtype=torch.int64),))


_I32, _I64, _F64 = torch.int32, torch.int64, torch.float64


@pytest.mark.parametrize("bad", [
    "no_operands", "k_mismatch", "row_length", "splitter_length",
    "row_device", "splitter_device", "row_2d", "unsupported_dtype",
    "no_splitters"])
def test_plan_refuses(bad):
    """Every mismatch the kernel cannot take raises InvalidError before a
    descriptor exists."""
    a = torch.zeros(1024, dtype=_I32)
    s = torch.zeros(5, dtype=_I32)
    ops, sops = {
        "no_operands": ((), ()),
        "k_mismatch": ((a, a), (s,)),
        "row_length": ((a, torch.zeros(1023, dtype=_I32)), (s, s)),
        "splitter_length": ((a, a), (s, torch.zeros(4, dtype=_I32))),
        "row_device": ((a, torch.zeros(1024, dtype=_I32, device="meta")),
                       (s, s)),
        "splitter_device": ((a,), (torch.zeros(5, dtype=_I32,
                                               device="meta"),)),
        "row_2d": ((torch.zeros((2, 512), dtype=_I32),), (s,)),
        "unsupported_dtype": ((torch.zeros(1024, dtype=torch.float32),),
                              (torch.zeros(5, dtype=torch.float32),)),
        "no_splitters": ((a,), (torch.zeros(0, dtype=_I32),)),
    }[bad]
    with pytest.raises(sp.InvalidError):
        sp.plan(ops, sops)


@pytest.mark.parametrize("dtypes,variant,image_bytes", [
    ((_I32,), sp.VARIANT_PACKED, 0),
    ((_I32, _I32), sp.VARIANT_PACKED, 0),               # the main path
    ((_I32,) * 3, sp.VARIANT_GENERAL, 4),
    ((_I32,) * 5, sp.VARIANT_GENERAL, 4),
    ((_I64,), sp.VARIANT_GENERAL, 4),                   # u32 only
    ((_I32, _I32, _I64), sp.VARIANT_GENERAL, 4),        # a wide int64 key
    ((_F64,), sp.VARIANT_GENERAL, 8),                   # f64 only
    ((_I32, _F64), sp.VARIANT_GENERAL, 8),              # an f64 key
    ((_I32, _I64, _F64), sp.VARIANT_GENERAL, 8),
])
@pytest.mark.parametrize("cap", [1024, 1023])
def test_plan_picks_variant_and_descriptor(dtypes, variant, image_bytes,
                                           cap):
    """The host-side choices for each operand-type mix: one or two int32
    operands count on packed 64-bit keys; any other mix takes the general
    path on 32-bit images, 64-bit when some operand is f64.  With 32-bit
    images an int32 operand is read directly and every other one gets an
    image row; with 64-bit images every operand does.  Image rows are
    padded to the 4-row load group.  The descriptor is [rows | splitters |
    row codes | splitter codes | the rows the count reads]."""
    ops = tuple(torch.zeros(cap, dtype=dt) for dt in dtypes)
    sops = tuple(torch.zeros(7, dtype=dt) for dt in dtypes)
    k = len(dtypes)
    image_ptr = 1 << 40
    p = sp.plan(ops, sops, image_ptr)
    assert (p.variant, p.k, p.cap, p.n_split, p.image_bytes) == \
        (variant, k, cap, 7, image_bytes)
    codes = [{_I32: 0, _I64: 1, _F64: 2}[dt] for dt in dtypes]
    rows = [o.data_ptr() for o in ops]
    count_rows, n_images = list(rows), 0
    for i, dt in enumerate(dtypes):
        if image_bytes == 8 or (image_bytes == 4 and dt != _I32):
            count_rows[i] = image_ptr + n_images * 1024 * image_bytes
            n_images += 1
    assert p.image_rows == n_images
    if n_images:
        assert p.image_stride == 1024          # cap padded to 4 rows
        assert (p.image_stride * image_bytes) % 16 == 0
    else:
        assert p.image_stride == 0
    assert p.desc == tuple(rows + [so.data_ptr() for so in sops] + codes
                           + codes + count_rows)
    assert p.vec == all(r % 16 == 0 for r in rows)


@pytest.mark.parametrize("dtype", [_I32, _F64])
def test_plan_unaligned_view_takes_scalar_loads(dtype):
    """A view one element in is not 16-byte aligned: the plan turns the
    kernel's 16-byte loads off for the launch."""
    t = torch.zeros(1025, dtype=dtype)
    s = torch.zeros(3, dtype=dtype)
    assert t.data_ptr() % 16 == 0
    assert sp.plan((t[:1024],), (s,)).vec
    assert not sp.plan((t[1:],), (s,)).vec


@pytest.mark.parametrize("dtypes,admitted", [
    ((_I32,), {"packed", "general"}),
    ((_I32, _I32), {"packed", "general"}),
    ((_I32,) * 3, {"general"}),
    ((_I64,), {"general"}),
    ((_I32, _I64), {"general"}),
    ((_F64,), {"general"}),
    ((_I32, _F64), {"general"}),
])
def test_variants_admit_operands(dtypes, admitted):
    """Which paths can count a mix: the default is the first admitted, and
    planning a path that is not admitted raises."""
    names = ("packed", "general")
    ops = tuple(torch.zeros(64, dtype=dt) for dt in dtypes)
    sops = tuple(torch.zeros(3, dtype=dt) for dt in dtypes)
    assert {n for v, n in enumerate(names) if sp.admits(v, ops)} == admitted
    assert names[sp.plan(ops, sops).variant] == \
        next(n for n in names if n in admitted)
    for v, n in enumerate(names):
        if n in admitted:
            assert sp.plan(ops, sops, variant=v).variant == v
        else:
            with pytest.raises(sp.InvalidError, match="cannot count"):
                sp.plan(ops, sops, variant=v)


@pytest.mark.parametrize("dtypes,variant,want", [
    ((_I32,), sp.VARIANT_PACKED, 8 * 7),
    ((_I32, _I32), sp.VARIANT_PACKED, 8 * 7),
    ((_I32, _I32), sp.VARIANT_GENERAL, 2 * 4 * 7),
    ((_I32, _I64), sp.VARIANT_GENERAL, 2 * 4 * 7),
    ((_I32, _F64), sp.VARIANT_GENERAL, 2 * 8 * 7),
])
def test_splitter_shared_memory(dtypes, variant, want):
    """The shared memory a launch's splitter images take (the bound on S
    the kernel error names): one 64-bit key per splitter when packed."""
    ops = tuple(torch.zeros(64, dtype=dt) for dt in dtypes)
    sops = tuple(torch.zeros(7, dtype=dt) for dt in dtypes)
    assert sp.splitter_bytes(sp.plan(ops, sops, variant=variant)) == want
