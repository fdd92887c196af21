"""K2, the fingerprint hash (``ops/fingerprint.py``, ``csrc/fingerprint.cu``), on the CPU.

On CPU tensors the wrappers take their plain versions, which must give the JAX
package's uint32 values (``constraint_solver_tpu/ops/fingerprint.py``) bit for
bit: ``hash_xor`` with 1-4 terms, with and without a base, on the broadcast
shapes the descents give it and on int32 and int64 inputs with negatives and
values at and above 2^31; each rewired call site against its JAX counterpart;
and small population trajectories against the JAX solvers.  The C plan that a
CUDA launch would take is a pure function of shapes, strides and dtypes, tested
here: stride 0 exactly on broadcast dimensions, each operand's own pointer (no
copy of an expanded view), the layouts ``csrc/fingerprint.cu`` reads.  The
library's lazy build and load run under a faked compiler and ``ctypes``.  The
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2d)."""

import ctypes
import importlib
import os
import re
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models import diagram_layout as jd
from constraint_solver_tpu.models import qap as jq
from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu.models.nqueens import make_nqueens_problem as j_nqueens
from constraint_solver_tpu.ops import fingerprint as jfp
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import ackley as ta
from constraint_solver_tpu_torch.models import diagram_layout as td
from constraint_solver_tpu_torch.models import qap as tq
from constraint_solver_tpu_torch.models import scheduling as ts
from constraint_solver_tpu_torch.models.nqueens import NQMoves, make_nqueens_problem
from constraint_solver_tpu_torch.ops import fingerprint as fp
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.parallel import population as tpop
from constraint_solver_tpu_torch.utils import roofline as rl
from constraint_solver_tpu_torch.utils.convert import to_reference
from jax_key_draws import JaxKeyDraws, reference_log_weights
from test_torch_population import assert_tree_equal

ja = importlib.import_module("constraint_solver_tpu.models.ackley")  # the package exports a function of that name
P, W, N_OFF, D, E = 4, 6, 3, 9, 5


def _ints(rng, shape, dtype):
    """Values over the whole range of ``dtype``, with -1, 0, 2^31 - 1 and (for
    int64) 2^31, 2^32 - 1 and 2^32 planted: both bit patterns and the low 32 bits."""
    if dtype == torch.int32:
        x = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        planted = [-1, 0, 2**31 - 1, -2**31]
    else:
        x = rng.integers(-2**40, 2**40, size=shape, dtype=np.int64)
        planted = [-1, 0, 2**31 - 1, 2**31, 2**32 - 1, 2**32]
    flat = x.reshape(-1)
    flat[: len(planted)] = planted[: flat.size]
    return torch.from_numpy(x)


def _u32(t):
    """A port tensor as the JAX package's uint32 (its low 32 bits)."""
    return jnp.asarray((t.numpy().astype(np.int64) & 0xFFFFFFFF).astype(np.uint32))


def _jax_hash(base, terms):
    """The JAX package's composition: base ^ XOR_k position_hash(idx_k, val_k), [..., 2]."""
    out = None
    for idx, val in terms:
        h = jfp.position_hash(_u32(idx), _u32(val))
        out = h if out is None else out ^ h
    return out if base is None else _u32(base) ^ out


def _shape_case(kind, rng, dtype, k):
    """k (idx, val) terms and a base at one of the descents' broadcast shapes."""
    if kind == "[P]":
        terms = [(_ints(rng, (P,), dtype), _ints(rng, (P,), dtype)) for _ in range(k)]
        base = torch.from_numpy(rng.integers(0, 2**32, size=(P, 2), dtype=np.int64))
    elif kind == "[P, W]":
        terms = [(_ints(rng, (P, W), dtype), _ints(rng, (P, W), dtype)) for _ in range(k)]
        base = torch.from_numpy(rng.integers(0, 2**32, size=(P, 2), dtype=np.int64)).view(P, 1, 2)
    else:  # "[P, n_off, D]": the roster's swap diagonals, expanded views as the proposer passes them
        iota = torch.arange(D, dtype=dtype)
        a = _ints(rng, (P, D), dtype)
        pool = [(iota.expand(P, N_OFF, D), a[:, None, :].expand(P, N_OFF, D)),
                (iota.expand(P, N_OFF, D), _ints(rng, (P, N_OFF, D), dtype)),
                (_ints(rng, (P, N_OFF, D), dtype), a[:, None, :].expand(P, N_OFF, D)),
                (_ints(rng, (P, N_OFF, 1), dtype), _ints(rng, (D,), dtype))]
        terms = pool[:k]
        base = torch.from_numpy(rng.integers(0, 2**32, size=(P, 2), dtype=np.int64)).view(P, 1, 1, 2)
    return base, terms


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("with_base", [False, True], ids=["no-base", "base"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["[P]", "[P, W]", "[P, n_off, D]"])
def test_hash_xor_equals_the_jax_composition(kind, k, with_base, dtype):
    rng = np.random.default_rng(zlib.crc32(repr((kind, k, with_base, str(dtype))).encode()))
    base, terms = _shape_case(kind, rng, dtype, k)
    base = base if with_base else None
    want = np.asarray(_jax_hash(base, terms))
    got = fp.hash_xor(base, terms)
    assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    planes = fp.hash_xor(base, terms, planes=True)
    assert tuple(planes.shape) == (2, *want.shape[:-1])
    np.testing.assert_array_equal(planes.numpy(), np.moveaxis(want, -1, 0).astype(np.int64))
    assert ((got >= 0) & (got < 2**32)).all()


def test_public_forms_equal_the_jax_package():
    rng = np.random.default_rng(1)
    idx, val = _ints(rng, (P, W), torch.int32), _ints(rng, (P, W), torch.int64)
    want = jfp.position_hash_planes(_u32(idx), _u32(val))
    got = fp.position_hash_planes(idx, val)
    assert len(got) == 2 and all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    np.testing.assert_array_equal(fp.position_hash(idx, val).numpy(), np.asarray(jfp.position_hash(_u32(idx), _u32(val))))
    base = torch.from_numpy(rng.integers(0, 2**32, size=(P, W, 2), dtype=np.int64))
    old, new = _ints(rng, (P, W), torch.int32), _ints(rng, (P, W), torch.int32)
    got = fp.fp_update(base, idx, old, new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfp.fp_update(_u32(base), _u32(idx), _u32(old), _u32(new))))
    np.testing.assert_array_equal(got.numpy(), fp.fp_update_ref(base, idx, old, new).numpy())


@pytest.mark.parametrize("shape", [(1,), (5, 1), (4, 257), (3, 365), (2, 1000), (2, 3, 40), (2, 2, 2, 33)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_fingerprint_rows_equal_the_jax_package(shape, dtype):
    values = _ints(np.random.default_rng(len(shape) * 1000 + shape[-1]), shape, dtype)
    want = jfp.fingerprint_i32(jnp.asarray(values.numpy().astype(np.int64).astype(np.int32)))
    np.testing.assert_array_equal(fp.fingerprint_i32(values).numpy(), np.asarray(want))
    np.testing.assert_array_equal(fp.fingerprint_i32(values).numpy(), fp.fingerprint_i32_ref(values).numpy())


def test_fingerprint_f32_hashes_the_bit_patterns():
    x = np.array([[0.0, -0.0, np.nan, -np.inf, 1.5, -2.25]], dtype=np.float32)
    x.view(np.int32)[0, 2] = 0x7FC00123  # a NaN payload
    want = jfp.fingerprint_f32(jnp.asarray(x))
    np.testing.assert_array_equal(fp.fingerprint_f32(torch.from_numpy(x)).numpy(), np.asarray(want))
    strided = torch.from_numpy(np.repeat(x, 2, axis=1))[:, ::2]  # a strided float view, hashed as it is
    np.testing.assert_array_equal(fp.fingerprint_f32(strided).numpy(), np.asarray(want))


def test_zero_size_operands_return_empty_without_the_kernel(monkeypatch):
    monkeypatch.setattr(fp._LIBRARY, "entry", lambda entry: pytest.fail("a zero-size call reached the kernel"))
    empty = torch.zeros((P, 0, D), dtype=torch.int64)
    assert fp.hash_xor(None, ((empty, empty),), planes=True).shape == (2, P, 0, D)
    assert fp.hash_xor(torch.zeros((P, 1, 1, 2), dtype=torch.int64), ((empty, empty),)).shape == (P, 0, D, 2)
    assert fp.fingerprint_i32(torch.zeros((0, D), dtype=torch.int32)).shape == (0, 2)
    assert torch.equal(fp.fingerprint_i32(torch.zeros((3, 0), dtype=torch.int32)), torch.zeros((3, 2), dtype=torch.int64))


def test_wrappers_check_their_operands():
    x = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32 or torch.int64"):
        fp.hash_xor(None, ((x, x.to(torch.int16)),))
    with pytest.raises(ValueError, match="1 to 4"):
        fp.hash_xor(None, ((x, x),) * 5)
    with pytest.raises(ValueError, match="pairs"):
        fp.hash_xor(None, ((x, x, x),))
    with pytest.raises(ValueError, match="int64"):
        fp.hash_xor(torch.zeros((3, 3), dtype=torch.int64), ((x, x),))
    with pytest.raises(ValueError, match="at most 4"):
        fp.hash_xor(None, ((torch.zeros((1,) * 5, dtype=torch.int64), x),))
    with pytest.raises(RuntimeError):
        fp.hash_xor(None, ((torch.zeros(3, dtype=torch.int64), torch.zeros(4, dtype=torch.int64)),))
    with pytest.raises(ValueError, match="1 to 4"):
        fp.fingerprint_i32(torch.zeros((1,) * 5, dtype=torch.int32))
    with pytest.raises(TypeError):
        fp.fingerprint_i32(torch.zeros(3, dtype=torch.float32))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(fp._LIBRARY, "entry", lambda entry: pytest.fail("the CPU path reached the kernel"))
    before = (fp.hash_xor.launches, fp.fingerprint_i32.launches)
    rng = np.random.default_rng(2)
    base, terms = _shape_case("[P, W]", rng, torch.int64, 4)
    assert torch.equal(fp.hash_xor(base, terms), fp.hash_xor_ref(base, terms))
    values = _ints(rng, (P, 50), torch.int32)
    assert torch.equal(fp.fingerprint_i32(values), fp.fingerprint_i32_ref(values))
    assert (fp.hash_xor.launches, fp.fingerprint_i32.launches) == before


# ---------------------------------------------------------------- the plans


def test_hash_plan_strides_are_zero_exactly_on_broadcast_dimensions():
    a = torch.zeros((P, D), dtype=torch.int64)
    iota = torch.arange(D)
    d1 = iota.expand(P, N_OFF, D)  # strides (0, 0, 1)
    ab = a[:, None, :].expand(P, N_OFF, D)  # strides (D, 0, 1)
    a2 = torch.zeros((P, N_OFF, D), dtype=torch.int32)
    col = torch.zeros((P, N_OFF, 1), dtype=torch.int64)
    base = torch.zeros((P, 2), dtype=torch.int64).view(P, 1, 1, 2)
    operands = (d1, ab, d1, a2, col, iota, col, a2)
    plan = fp._hash_plan((base.shape, base.stride(), base.dtype),
                         tuple((t.shape, t.stride(), t.dtype) for t in operands),
                         fp._alias(tuple(t.data_ptr() for t in operands)), False)
    assert plan.out_shape == (P, N_OFF, D)
    t = plan.template
    assert len(t) == fp.HASH_PLAN_LEN and t[:6] == (1, P, N_OFF, D, P * N_OFF * D, 4)
    assert t[6:10] == (0, 2, 1, 1)  # the output pointer (filled at launch), [..., 2]: step 2, lane 1; base lane stride 1
    assert t[10:16] == (0, 0, 2, 0, 0, 1)  # base [P, 1, 1, 2]: stride 2 over P only
    got = [(t[16 + 6 * m + 1: 16 + 6 * m + 5], t[16 + 6 * m + 5]) for m in range(8)]
    assert got == [
        ((0, 0, 0, 1), 1), ((0, D, 0, 1), 1), ((0, 0, 0, 1), 1), ((0, N_OFF * D, D, 1), 0),
        ((0, N_OFF, 1, 0), 1), ((0, 0, 0, 1), 1), ((0, N_OFF, 1, 0), 1), ((0, N_OFF * D, D, 1), 0),
    ]
    # Bytes: each distinct operand's elements once, however many terms pass it: d1 (iota
    # expanded, so iota too): D; ab: P·D; col: P·N_OFF; a2 in int32: numel; then base and output.
    numel = P * N_OFF * D
    want_bytes = 8 * (D + P * D + P * N_OFF) + 4 * numel + 16 * P + 16 * numel
    assert plan.work == (fp.OPS_PER_HASH * 4 * numel + 2 * numel, want_bytes)
    # Told that no two operands share an address, the plan reads each once.
    apart = fp._hash_plan((base.shape, base.stride(), base.dtype),
                          tuple((t.shape, t.stride(), t.dtype) for t in operands), tuple(range(8)), False)
    assert apart.work[1] - want_bytes == 8 * (D + D + P * N_OFF) + 4 * numel
    # Another view of one tensor that reads other elements counts them: a[:, :1] within a.
    a_first = a[:, None, :1].expand(P, N_OFF, D)
    rest = fp._hash_plan(None, tuple((t.shape, t.stride(), t.dtype) for t in (ab, a_first)), (0, 0), False)
    assert rest.work[1] == 8 * (P * D + P) + 16 * numel
    planes = fp._hash_plan(None, tuple((t.shape, t.stride(), t.dtype) for t in operands[:2]), (0, 1), True)
    assert planes.template[5:10] == (1, 0, 1, numel, 0) and planes.template[10:16] == (0,) * 6
    assert planes.template[16 + 12:] == (0,) * (fp.HASH_PLAN_LEN - 28)


def test_hash_values_carry_each_operands_own_pointer():
    """The launch reads an expanded view where it lies: no operand is copied."""
    a = torch.arange(P * D, dtype=torch.int64).view(P, D)
    ab = a[:, None, :].expand(P, N_OFF, D)
    iota = torch.arange(D)[2:]  # a view with a storage offset
    val = torch.zeros((P, N_OFF, D - 2), dtype=torch.int32)
    operands = (ab[..., 2:], val, iota, val)
    ptrs = tuple(t.data_ptr() for t in operands)
    plan = fp._hash_plan(None, tuple((t.shape, t.stride(), t.dtype) for t in operands), fp._alias(ptrs), True)
    out = torch.empty((2, *plan.out_shape), dtype=torch.int64)
    values = fp._hash_values(plan, out, None, ptrs)
    assert values[6] == out.data_ptr() and values[10] == 0
    assert [values[16 + 6 * m] for m in range(4)] == [t.data_ptr() for t in operands]
    assert values[16] == a.data_ptr() + 2 * 8 and values[28] == iota.data_ptr()
    assert values[17:21] == [0, D, 0, 1]


@pytest.mark.parametrize("n, wpr", [(1, 1), (256, 1), (257, 2), (365, 2), (512, 2), (1000, 4), (1024, 4),
                                    (1025, 8), (4096, 8), (16384, 8)])
def test_rows_plan_groups_warps_per_row(n, wpr):
    for rows in (1, 7, 256):
        plan = fp._rows_plan((rows, n), (n, 1), torch.int32)
        assert plan.warps_per_row == wpr and plan.lead == (1, 1, rows) and plan.rows == rows
        if plan.splits == 1:
            assert plan.grid == -(-rows // (8 // wpr)) and plan.chunk == n
        else:  # a few rows of 8 warps: each split over several blocks (tests/test_torch_tabu_probe.py)
            assert wpr == 8 and rows < nk._SMS and plan.grid == rows * plan.splits
        assert plan.strides == (0, 0, n if rows > 1 else 0, 1 if n > 1 else 0)
        assert -(-n // (32 * wpr)) <= 8 or wpr == 8  # at most 8 positions a thread below 8 warps
        assert plan.work == (fp.OPS_PER_HASH * rows * n, 4 * rows * n + 16 * rows)


def test_rows_plan_takes_strided_and_broadcast_rows():
    v = torch.zeros((3, 40), dtype=torch.int64)[:, ::4]
    plan = fp._rows_plan(v.shape, v.stride(), v.dtype)
    assert plan.strides == (0, 0, 40, 4) and plan.n == 10 and plan.wide == 1
    e = torch.zeros(40, dtype=torch.int32).expand(5, 2, 40)
    plan = fp._rows_plan(e.shape, e.stride(), e.dtype)
    assert plan.lead == (1, 5, 2) and plan.strides == (0, 0, 0, 1) and plan.work[1] == 4 * 40 + 16 * 10
    out = torch.empty((5, 2, 2), dtype=torch.int64)
    assert fp._rows_values(plan, e, out) == (e.data_ptr(), 0, 0, 0, 1, 0, 1, 5, 2, 10, 40, out.data_ptr(), 1, 2, 1,
                                             40)


def test_plan_layouts_match_the_cuda_source():
    src = fp._SRC.read_text()
    for name, value in (("kDims", fp.MAX_DIMS), ("kMaxTerms", fp.MAX_TERMS), ("kThreads", fp.THREADS),
                        ("kRowsPlanLen", fp.ROWS_PLAN_LEN), ("kProbePlanLen", fp.PROBE_PLAN_LEN),
                        ("kProbeTile", fp.PROBE_TILE)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value), name
    assert f"kHashPlanLen == {fp.HASH_PLAN_LEN}" in src and f"kRowsPlanLen == {fp.ROWS_PLAN_LEN}" in src
    assert f"kProbePlanLen == {fp.PROBE_PLAN_LEN}" in src
    assert re.search(r"constexpr int kNqMovePlanLen = (\d+);", src).group(1) == str(fp.NQ_MOVE_PLAN_LEN)
    assert f"kNqMovePlanLen == {fp.NQ_MOVE_PLAN_LEN}" in src
    assert len(fp._rows_values(fp._rows_plan((2, 3), (3, 1), torch.int32), torch.zeros((2, 3), dtype=torch.int32),
                               torch.zeros((2, 2), dtype=torch.int64))) == fp.ROWS_PLAN_LEN
    hashed = (fp._SRC.parent / "fp_hash.cuh").read_text()  # the hash and its salts, shared with K5
    assert '#include "fp_hash.cuh"' in src
    for salt in fp._SALTS:
        assert f"0x{salt:08X}u" in hashed


# ---------------------------------------------------------------- the call sites


def test_swap_fp_delta_planes_equal_the_jax_package():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, E, size=(P, D)))
    iota = torch.arange(D)
    a2 = torch.from_numpy(rng.integers(0, E, size=(P, N_OFF, D)))
    d2 = torch.from_numpy(rng.integers(0, D, size=(P, N_OFF, D)))
    args = (iota.expand(P, N_OFF, D), a[:, None, :].expand(P, N_OFF, D), a2, d2, a2, a[:, None, :].expand(P, N_OFF, D))
    got = ts._swap_fp_delta_planes(*args)
    want = js._swap_fp_delta_planes(*(jnp.asarray(x.numpy().astype(np.int32)) for x in args))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["dense", "compact", "incremental"])
def test_qap_swap_fp_equals_the_jax_package(mode):
    """Every candidate's fingerprint of each mode's neighborhood, one K2a call
    for both positions against the JAX package's two ``fp_update``s."""
    n = 12
    kw = {"dense": {}, "compact": {"compact": True}, "incremental": {"incremental": True}}[mode]
    jp = jq.make_qap_problem(jq.QAPSpec.random(n, seed=4), **kw)
    tp = tq.make_qap_problem(tq.QAPSpec.random(n, seed=4), **kw)
    draws = JaxKeyDraws(jax.random.split(jax.random.key(0), P))
    state = tp.init(draws)
    draws.round_keys()
    if mode == "incremental":
        jstate = jq.QAPState(jnp.asarray(state.p.numpy().astype(np.int32)), jnp.asarray(state.g.numpy()),
                             jnp.asarray(state.h.numpy()))
    else:
        jstate = jnp.asarray(state.numpy().astype(np.int32))
    cur_fp = tp.fingerprint(state)
    np.testing.assert_array_equal(cur_fp.numpy(), np.asarray(jax.vmap(jp.fingerprint)(jstate)))
    nb = tp.neighborhood(state, tp.score(state), draws, torch.ones(P, dtype=torch.bool))
    jnb = jax.vmap(lambda s: jp.neighborhood(s, jp.score(s), jax.random.key(0)))(jstate)
    width = nb.valid.shape[1]
    assert jnb.valid.shape == (P, width)
    got = tp.move_fp(state, cur_fp, nb.moves, torch.arange(width).expand(P, width))
    want = jax.vmap(lambda s, f, mv: jax.vmap(lambda i: jp.move_fp(s, f, mv, i))(jnp.arange(width)))(
        jstate, _u32(cur_fp), jnb.moves)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_diagram_move_fp_equals_the_jax_package():
    jspec, tspec = jd.DiagramLayoutSpec.random(8, 10, 8, seed=3), td.DiagramLayoutSpec.random(8, 10, 8, seed=3)
    jp, tp = jd.make_diagram_layout_problem(jspec), td.make_diagram_layout_problem(tspec)
    sizes, _ = tspec.arrays()
    rng = np.random.default_rng(5)
    pos = np.stack([rng.integers(0, tspec.grid - sizes + 1) for _ in range(P)])
    tpos = torch.from_numpy(pos)
    cur_fp = tp.fingerprint(tpos)
    np.testing.assert_array_equal(cur_fp.numpy(), np.asarray(jax.vmap(jp.fingerprint)(jnp.asarray(pos))))
    jnb = jax.vmap(lambda q: jp.neighborhood(q, jp.score(q), jax.random.key(0)))(jnp.asarray(pos))
    width = jnb.valid.shape[1]
    idx = torch.from_numpy(rng.integers(0, width, size=(P, 7)))
    got = tp.move_fp(tpos, cur_fp, None, idx)
    want = jax.vmap(lambda q, f, mv, ii: jax.vmap(lambda i: jp.move_fp(q, f, mv, i))(ii))(
        jnp.asarray(pos), _u32(cur_fp), jnb.moves, jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ackley_move_fp_equals_the_jax_package():
    d = 5
    jp, tp = ja.make_ackley_problem(d), ta.make_ackley_problem(d)
    keys = jax.random.split(jax.random.key(6), P)
    draws = JaxKeyDraws(keys)
    x = tp.init(draws)
    x[0, 0], x[1, 1] = -0.0, 0.0  # signed zeros: distinct bit patterns
    xj = jnp.asarray(x.numpy())
    draws.round_keys()
    nb = tp.neighborhood(x, tp.score(x), draws, torch.ones(P, dtype=torch.bool))
    jnb = jax.vmap(lambda xi, k: jp.neighborhood(xi, jp.score(xi), k))(xj, draws._nb_key)
    cur_fp = tp.fingerprint(x)
    np.testing.assert_array_equal(cur_fp.numpy(), np.asarray(jax.vmap(jp.fingerprint)(xj)))
    idx = torch.arange(2 * d).expand(P, 2 * d)
    got = tp.move_fp(x, cur_fp, nb.moves, idx)
    want = jax.vmap(lambda q, f, m0, m1: jax.vmap(lambda i: jp.move_fp(q, f, (m0, m1), i))(jnp.arange(2 * d)))(
        xj, _u32(cur_fp), jnb.moves[0], jnb.moves[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- accounting


def test_roofline_counts_k2_by_its_plan_and_no_chain_op():
    rng = np.random.default_rng(7)
    base, terms = _shape_case("[P, n_off, D]", rng, torch.int64, 4)
    values = _ints(rng, (P, 365), torch.int32)
    with rl.counting() as count:
        fp.hash_xor(base, terms)
        fp.fingerprint_i32(values)
    operands = [t for pair in terms for t in pair]
    hplan = fp._hash_plan((base.shape, base.stride(), base.dtype),
                          tuple((t.shape, t.stride(), t.dtype) for t in operands),
                          fp._alias(tuple(t.data_ptr() for t in operands)), False)
    rplan = fp._rows_plan(values.shape, values.stride(), values.dtype)
    assert dict(count.kernels[fp.HASH_KERNEL]) == {"calls": 1, "flops": hplan.work[0], "bytes": hplan.work[1]}
    assert dict(count.kernels[fp.ROWS_KERNEL]) == {"calls": 1, "flops": rplan.work[0], "bytes": rplan.work[1]}
    assert (count.flops, count.bytes) == (hplan.work[0] + rplan.work[0], hplan.work[1] + rplan.work[1])


# ---------------------------------------------------------------- the library


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    compiled, loaded = [], []

    def run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        compiled.append((cmd, threading.get_ident()))
        time.sleep(0.05)  # a compile takes a while: let the other threads reach the lock
        with open(out, "w") as f:
            f.write("library")
        return nk.subprocess.CompletedProcess(cmd, 0, "", "")

    class Library:
        def __init__(self, path):
            loaded.append(path)
            self.fp_hash_xor_launch = type("Entry", (), {})()
            self.fingerprint_rows_launch = type("Entry", (), {})()
            self.fp_hash_probe_launch = type("Entry", (), {})()
            self.fp_nq_move_launch = type("Entry", (), {})()

    monkeypatch.setattr(nk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nk.subprocess, "run", run)
    monkeypatch.setattr(nk.ctypes, "CDLL", Library)
    monkeypatch.setattr(fp, "_LIBRARY", nk.KernelLibrary(fp._SRC, tmp_path / "libfingerprint.so",
                                                         fp._LIBRARY.argtypes))
    return compiled, loaded


def test_concurrent_first_use_builds_and_loads_once(fake_toolchain):
    compiled, loaded = fake_toolchain
    threads_n = 8
    barrier = threading.Barrier(threads_n)
    got, errors = [], []

    def first_use(entry):
        try:
            barrier.wait(timeout=30)
            got.append((entry, fp._LIBRARY.entry(entry)))
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        names = ["fp_hash_xor_launch", "fingerprint_rows_launch", "fp_hash_probe_launch"]
        threads = [threading.Thread(target=first_use, args=(names[i % 3],)) for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(compiled) == 1 and len(loaded) == 1 and len(got) == threads_n
    assert len({id(fn) for name, fn in got if name == "fp_hash_xor_launch"}) == 1
    cmd, ident = compiled[0]
    assert cmd[-1] == str(fp._SRC) and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1].endswith(f"libfingerprint.so.{os.getpid()}.{ident}.tmp")
    # Every C entry takes (const long long* plan, void* stream) and returns an int.
    src = fp._SRC.read_text()
    for name in ("fp_hash_xor_launch", "fingerprint_rows_launch", "fp_hash_probe_launch", "fp_nq_move_launch"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
        assert [q.strip() for q in params.split(",")] == ["const long long* plan", "void* stream"]
        fn = fp._LIBRARY.entry(name)
        assert fn.argtypes == [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p] and fn.restype is ctypes.c_int


def test_the_library_is_built_where_the_smoke_names_it():
    """``chip_smoke.py``'s phase 1 builds each kernel module's library and
    names it by the module's ``_LIB_PATH``."""
    assert fp._LIBRARY.lib == fp._LIB_PATH == nk._BUILD_DIR / "libfingerprint.so"
    assert fp._LIBRARY.src == fp._SRC and set(fp._LIBRARY.argtypes) == {"fp_hash_xor_launch",
                                                                        "fingerprint_rows_launch",
                                                                        "fp_hash_probe_launch",
                                                                        "fp_nq_move_launch"}


def test_a_failed_build_raises(fake_toolchain, monkeypatch):
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 2, "", "error: no sm_90a"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fp._LIBRARY.entry("fp_hash_xor_launch")
    assert fp._LIBRARY.entries is None


# ---------------------------------------------------------------- trajectories


def _trajectory(jsolver, tsolver, chunks=3):
    assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    for _ in range(chunks):
        np.testing.assert_array_equal(tsolver.execute_chunk_traced(2), jsolver.execute_chunk_traced(2))
        assert_tree_equal(jsolver.state, to_reference(tsolver.state))
    assert tsolver.stats() == jsolver.stats()


def test_nqueens64_trajectory_is_unchanged():
    n, p, seed = 64, 8, "k2-nqueens"
    kw = dict(seed=seed, local_search_max_iterations=6, best_solutions_capacity=3, all_solutions_capacity=16,
              all_solution_iteration_expiry=40, restart_every=4)
    jsolver = jpop.PopulationSolver(j_nqueens(n), JConfig(**kw), population=p, exchange_every=2)
    tsolver = tpop.PopulationSolver(
        make_nqueens_problem(n, log_weights=reference_log_weights(n)), SolverConfig(**kw), population=p,
        exchange_every=2, draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    _trajectory(jsolver, tsolver)


def test_qap64_trajectory_is_unchanged():
    n, p, seed = 64, 8, "k2-qap"
    kw = dict(seed=seed, local_search_max_iterations=8, best_solutions_capacity=3, all_solutions_capacity=16,
              all_solution_iteration_expiry=40, restart_every=3, max_allow_no_improvement_for=4)
    jsolver = jpop.PopulationSolver(jq.make_qap_problem(jq.QAPSpec.random(n, seed=11), incremental=True),
                                    JConfig(**kw), population=p, exchange_every=2)
    tsolver = tpop.PopulationSolver(
        tq.make_qap_problem(tq.QAPSpec.random(n, seed=11), incremental=True), SolverConfig(**kw), population=p,
        exchange_every=2, draws=JaxKeyDraws(jax.random.split(seed_string_to_key(seed), p)), device="cpu",
    )
    _trajectory(jsolver, tsolver)


# ---------------------------------------------------------------- K7, the fingerprints of N-Queens candidates


def _k7_args(rng, p, a, n, w, dtype=torch.int64):
    """(cur_fp, cols, rows, idx): idx [P] when ``w`` is None, the exact
    filter's expanded iota [P, A·n] when it is "all", else [P, w]."""
    cur = torch.as_tensor(rng.integers(0, 2**32, (p, 2)))
    cols = torch.as_tensor(np.stack([rng.choice(n, a, replace=False) for _ in range(p)]))
    rows = torch.as_tensor(rng.integers(0, n, (p, n)))
    if w is None:
        idx = torch.as_tensor(rng.integers(0, a * n, p))
    elif w == "all":
        idx = torch.arange(a * n).expand(p, a * n)
    else:
        idx = torch.as_tensor(rng.integers(0, a * n, (p, w)))
    return cur, cols, rows, idx.to(dtype)


def _decode_then_fp_update(cur_fp, cols, rows, idx):
    """The N-Queens model's move_fp before K7: the decode, then ``fp_update``."""
    return fp.nqueens_move_fp_ref(cur_fp, cols, rows, idx, update=fp.fp_update)


@pytest.mark.parametrize("p, a, n, w, dtype", [
    (6, 3, 16, None, torch.int64), (6, 3, 16, "all", torch.int64), (4, 50, 1000, None, torch.int64),
    (3, 5, 37, "all", torch.int32), (5, 2, 8, 7, torch.int32), (1, 1, 1, None, torch.int64),
])
def test_nqueens_move_fp_equals_the_decode_then_fp_update(p, a, n, w, dtype):
    """K7's plain version (what the wrapper runs on the CPU) against the chain
    the model ran before it, at a pick (W = 1), under the exact filter (W = A·n)
    and on int32 candidates; and the model's move_fp against both."""
    rng = np.random.default_rng(p * 100 + n)
    args = _k7_args(rng, p, a, n, w, dtype)
    got = fp.nqueens_move_fp(*args)
    want = _decode_then_fp_update(*args)
    assert got.dtype == torch.int64 and got.shape == (*args[3].shape, 2) and torch.equal(got, want)
    assert torch.equal(fp.nqueens_move_fp_ref(*args), want)
    problem = make_nqueens_problem(n, sample_cols=a)
    cur, cols, rows, idx = args
    state = problem.init(JaxKeyDraws(jax.random.split(jax.random.key(0), p)))._replace(rows=rows)
    assert torch.equal(problem.move_fp(state, cur, NQMoves(cols, n), idx), want)


def test_nqueens_move_fp_takes_strided_candidates_and_counts_no_launch_on_the_cpu():
    rng = np.random.default_rng(9)
    cur, cols, rows, idx = _k7_args(rng, 4, 5, 21, 14, torch.int32)
    strided = idx[:, ::2]
    before = fp.nqueens_move_fp.launches
    got = fp.nqueens_move_fp(cur, cols, rows, strided)
    assert fp.nqueens_move_fp.launches == before
    assert torch.equal(got, _decode_then_fp_update(cur, cols, rows, strided.contiguous()))


def test_nqueens_move_plan_layout_and_work():
    """K7's C plan: P, W, n, A, then (pointer, 2 strides) of cur_fp, cols,
    rows and idx, idx's width and the output pointer; stride 0 on idx's
    broadcast dimensions (the exact filter's expanded iota, a pick's [P, 1]);
    the work counts idx's distinct elements once."""
    meta = lambda t: (t.shape, t.stride(), t.dtype)  # noqa: E731
    cur, cols, rows = torch.zeros((8, 2), dtype=torch.int64), torch.zeros((8, 3), dtype=torch.int64), \
        torch.zeros((8, 64), dtype=torch.int64)
    iota = torch.arange(192).expand(8, 192)
    plan = fp._nq_move_plan(meta(cur), meta(cols), meta(rows), meta(iota))
    assert plan.template == (8, 192, 64, 3, 0, 2, 1, 0, 3, 1, 0, 64, 1, 0, 0, 1, 1, 0)
    assert len(plan.template) == fp.NQ_MOVE_PLAN_LEN
    assert plan.work == ((2 * fp.OPS_PER_HASH + 4) * 8 * 192, 16 * 8 + 8 * 192 + 16 * 8 * 3 + 16 * 8 * 192)
    pick = torch.zeros(8, dtype=torch.int32)[:, None]
    plan = fp._nq_move_plan(meta(cur), meta(cols), meta(rows), meta(pick))
    assert plan.template[13:17] == (0, 1, 0, 0)  # int32, a lane stride of 1, the one candidate's 0
    assert plan.work == ((2 * fp.OPS_PER_HASH + 4) * 8, 16 * 8 + 4 * 8 + 16 * 8 + 16 * 8)
    for bad in ((meta(cur.int()), meta(cols), meta(rows), meta(iota)),
                (meta(cur), meta(cols.int()), meta(rows), meta(iota)),
                (meta(cur), meta(cols), meta(rows[:4]), meta(iota)),
                (meta(cur), meta(cols), meta(rows), meta(iota[:4]))):
        with pytest.raises(ValueError):
            fp._nq_move_plan(*bad)
    with pytest.raises(TypeError):
        fp._nq_move_plan(meta(cur), meta(cols), meta(rows), meta(iota.to(torch.int16)))
    with pytest.raises(ValueError):
        fp.nqueens_move_fp(cur, cols, rows, torch.zeros((8, 2, 2), dtype=torch.int64))


def test_roofline_counts_k7_by_its_plan():
    rng = np.random.default_rng(11)
    cur, cols, rows, idx = _k7_args(rng, 4, 3, 16, "all")
    with rl.counting() as count:
        fp.nqueens_move_fp(cur, cols, rows, idx)
    plan = fp._nq_move_plan(*((t.shape, t.stride(), t.dtype) for t in (cur, cols, rows, idx)))
    assert dict(count.kernels[fp.NQ_MOVE_KERNEL]) == {"calls": 1, "flops": plan.work[0], "bytes": plan.work[1]}
    assert (count.flops, count.bytes) == plan.work
