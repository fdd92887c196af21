"""K6, the N-Queens column sample and the block's inputs (``ops/nqueens_sample.py``).

On the CPU the wrapper runs its plain version, which is held here against
the chain the N-Queens neighborhood ran before K6 (``torch.where``, a stable
descending ``torch.sort`` of the whole [P, n], the gathers), against an
independent numpy order (``np.lexsort`` by key, then column), and, on one
small case, against the JAX package's ``neighborhood`` on the same draws.
Inputs come from numpy seeds; every output must be equal bit for bit (the
key is one float32 add, the counters small integers).  Also: the launch plan
(a pure function of the shapes), ``kernel_work``, the input checks, the
roofline count, the faked build, and that the model's neighborhood and
PMC's sampled step take their sample from one K6 call and sort nothing
themselves.  The kernel runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2h)."""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from constraint_solver_tpu.models import nqueens as jnq
from constraint_solver_tpu_torch.models import nqueens as tnq
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops import nqueens_sample as ns
from constraint_solver_tpu_torch.utils import roofline
from constraint_solver_tpu_torch.utils.convert import from_reference
from jax_key_draws import JaxKeyDraws, reference_log_weights


def _old_chain(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a):
    """The neighborhood's sample and block inputs as the model computed them before K6."""
    n = cs.shape[1]
    conflicted = cs > 0
    logits = torch.where(conflicted, table[cs.long()], -torch.inf)
    c = torch.sort(logits + gumbel, dim=-1, descending=True, stable=True).indices[:, :a]
    col_valid = torch.arange(a) < torch.minimum(num_cols, n_conflicted)[:, None]
    r = rows.gather(1, c)
    removed = (rc.gather(1, r) - 1) + (dc.gather(1, r - c + (n - 1)) - 1) + (ac.gather(1, r + c) - 1)
    return c, c.to(torch.int32), r.to(torch.int32), removed, col_valid, col_valid.sum(dim=-1) * n


def _near_solved(rng, p, n, moved):
    """Solved boards (the even-n construction, n % 6 in {0, 4}) with ``moved``
    queens a lane put on random rows."""
    sol = np.array([2 * i + 1 for i in range(n // 2)] + [2 * i for i in range(n // 2)])
    boards = np.tile(sol, (p, 1))
    for b in boards:
        b[rng.choice(n, moved, replace=False)] = rng.integers(0, n, moved)
    return boards


def _args(rng, boards, a, kind="gumbel"):
    p, n = boards.shape
    st = tnq.build_state(torch.as_tensor(boards))
    cs = st.cs
    if kind == "ties":  # keys tie everywhere, at the threshold too
        gumbel = torch.as_tensor(rng.integers(-2, 3, (p, n)), dtype=torch.float32)
        cs = torch.as_tensor(rng.integers(0, 3, (p, n)), dtype=torch.float32)
    else:
        gumbel = torch.as_tensor(-np.log(-np.log(rng.random((p, n)).clip(1e-38))), dtype=torch.float32)
    if kind == "all":
        cs = cs.clamp_min(1.0)
    elif kind == "one":
        cs = torch.zeros_like(cs)
        cs[:, int(rng.integers(0, n))] = 2.0
    elif kind == "none":
        cs = torch.zeros_like(cs)
    n_conflicted = (cs > 0).sum(dim=-1)
    num_cols = torch.as_tensor(rng.integers(1, n_conflicted.clamp(1, a).numpy() + 1))
    return cs, tnq.default_log_weights(n), gumbel, num_cols, n_conflicted, st.rows, st.rc, st.dc, st.ac, a


def _numpy_order(cs, table, gumbel, a):
    """Each lane's A columns by descending key, lower column first among equal keys."""
    keys = np.where(cs.numpy() > 0, table.numpy()[cs.long().numpy()], -np.inf).astype(np.float32)
    keys = keys + gumbel.numpy()
    n = keys.shape[1]
    return np.stack([np.lexsort((np.arange(n), -k))[:a] for k in keys])


def _assert_sample_equal(got, want):
    for name, x, y in zip(ns.Sample._fields, got, want, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y), name


CASES = {
    "random (8, 100, 5)": (8, 100, 5, "gumbel"),
    "every column conflicted (4, 64, 7)": (4, 64, 7, "all"),
    "one conflicted (4, 50, 6)": (4, 50, 6, "one"),
    "none conflicted (3, 40, 4)": (3, 40, 4, "none"),
    "A = n (3, 24, 24)": (3, 24, 24, "gumbel"),
    "n not a multiple of 32 (5, 1003, 50)": (5, 1003, 50, "gumbel"),
    "ties (6, 90, 9)": (6, 90, 9, "ties"),
    "ties, A = 1 (6, 33, 1)": (6, 33, 1, "ties"),
    "n = 16384 (2, 16384, 64)": (2, 16384, 64, "gumbel"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_equals_the_old_chain_and_the_numpy_order(case):
    p, n, a, kind = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    args = _args(rng, rng.integers(0, n, (p, n)), a, kind)
    got = ns.nqueens_sample(*args)
    _assert_sample_equal(got, ns.nqueens_sample_ref(*args))
    _assert_sample_equal(got, _old_chain(*args))
    cs, table, gumbel = args[:3]
    np.testing.assert_array_equal(got.cols.numpy(), _numpy_order(cs, table, gumbel, a))
    assert got.c.is_contiguous() and got.r.is_contiguous() and got.removed.is_contiguous()
    n_conflicted = args[4]
    if kind == "none":
        assert not got.col_valid.any() and (got.n_valid == 0).all()
    if kind == "ties":  # the threshold's key is shared by columns inside and outside the sample
        keys = torch.where(cs > 0, table[cs.long()], -torch.inf) + gumbel
        kth = keys.gather(1, got.cols[:, -1:])
        assert ((keys == kth).sum(dim=1) > (torch.gather(keys, 1, got.cols) == kth).sum(dim=1)).any()
    assert torch.equal(got.n_valid, torch.minimum(args[3], n_conflicted).clamp(0, a) * n)


def test_near_solved_boards_fill_the_sample_from_the_inf_tail_in_column_order():
    """Fewer conflicted columns than A: the rest of the sample is the lowest
    unconflicted columns, in column order, and none of them is valid."""
    rng = np.random.default_rng(7)
    args = _args(rng, _near_solved(rng, 4, 1000, 3), 50)
    got = ns.nqueens_sample(*args)
    _assert_sample_equal(got, _old_chain(*args))
    cs = args[0]
    for lane in range(4):
        k = int((cs[lane] > 0).sum())
        assert k < 50
        tail = got.cols[lane, k:]
        assert torch.equal(tail, torch.nonzero(cs[lane] <= 0)[: 50 - k, 0])
        assert not got.col_valid[lane, k:].any()


def test_plain_version_equals_the_jax_neighborhood_on_its_draws():
    """P = 4, n = 16, A = 3: the JAX package's sampled columns, column mask
    and n_valid from the same keys, and r and removed by its arithmetic."""
    n, a, p = 16, 3, 4
    rng = np.random.default_rng(16)
    boards = rng.integers(0, n, (p, n)).astype(np.int32)
    jp = jnq.make_nqueens_problem(n, sample_cols=a)
    jst = jax.vmap(jnq.build_state)(jnp.asarray(boards))
    keys = jax.random.split(jax.random.key(n), p)
    k_nb = jax.vmap(jax.random.split)(keys)[:, 1]  # the descent's split
    nb_j = jax.jit(jax.vmap(jp.neighborhood))(jst, jax.vmap(jp.score)(jst), k_nb)

    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    tst = from_reference(jst, "cpu")
    n_conflicted = (tst.cs > 0).sum(dim=-1)
    gumbel, num_cols = draws.neighborhood(n, n_conflicted.clamp(1, a), torch.ones(p, dtype=torch.bool))
    table = torch.tensor(reference_log_weights(n), dtype=torch.float32)
    got = ns.nqueens_sample(tst.cs, table, gumbel, num_cols, n_conflicted, tst.rows, tst.rc, tst.dc, tst.ac, a)

    cols_j = np.asarray(nb_j.moves[0]).reshape(p, a, n)[:, :, 0]
    np.testing.assert_array_equal(got.cols.numpy(), cols_j)
    np.testing.assert_array_equal(got.col_valid.numpy(), np.asarray(nb_j.valid).reshape(p, a, n)[:, :, 0])
    np.testing.assert_array_equal(got.n_valid.numpy(), np.asarray(nb_j.n_valid))
    r_j = np.take_along_axis(np.asarray(jst.rows), cols_j, axis=1)
    np.testing.assert_array_equal(got.r.numpy(), r_j)

    def removed(rc, dc, ac, c, r):
        return (rc[r] - 1) + (dc[r - c + n - 1] - 1) + (ac[r + c] - 1)

    removed_j = jax.vmap(removed)(jst.rc, jst.dc, jst.ac, jnp.asarray(cols_j), jnp.asarray(r_j))
    np.testing.assert_array_equal(got.removed.numpy(), np.asarray(removed_j))


class _Ops(TorchDispatchMode):
    """Records the aten ops run under it, but for those inside ``muted``."""

    def __init__(self):
        super().__init__()
        self.ops, self.muted = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.muted:
            self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_the_neighborhood_takes_its_sample_from_one_k6_call_and_sorts_nothing_else(monkeypatch):
    """Outside K6 the neighborhood runs no sort: on the card the sample is one launch."""
    n, p = 40, 3
    problem = tnq.make_nqueens_problem(n, sample_cols=4)
    rng = np.random.default_rng(40)
    st = tnq.build_state(torch.as_tensor(rng.integers(0, n, (p, n))))
    keys = jax.random.split(jax.random.key(2), p)
    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    calls, mode = [], _Ops()
    inner = tnq.nqueens_sample

    def sample(*args, **kw):
        calls.append(args[-1])
        mode.muted = True
        try:
            return inner(*args, **kw)
        finally:
            mode.muted = False

    monkeypatch.setattr(tnq, "nqueens_sample", sample)
    problem = tnq.make_nqueens_problem(n, sample_cols=4)
    with mode:
        nb = problem.neighborhood(st, problem.score(st), draws, torch.ones(p, dtype=torch.bool))
    assert calls == [4]
    assert not [op for op in mode.ops if "sort" in op or "topk" in op], mode.ops
    assert nb.moves.cols.shape == (p, 4) and nb.n_valid.shape == (p,)


# ---------------------------------------------------------------- the plan and the work


@pytest.mark.parametrize("p, n, a, want", [
    (256, 1000, 50, (256, 4, 64, True, True, 64 * 8 + 4000, True)),
    (16, 16384, 64, (1024, 16, 64, True, True, 64 * 8 + 65536, True)),
    (4, 16, 3, (256, 1, 4, True, True, 32 + 64, True)),
    (2, 2048, 100, (512, 4, 128, True, True, 1024 + 8192, True)),
    (2, 2048, 300, (512, 4, 512, True, True, 4096 + 8192, False)),
    (2, 60000, 3000, (1024, 59, 4096, False, True, 32768, False)),
    (1, 40000, 20000, (1024, 40, 32768, True, False, 160000, False)),
    (1, 100000, 50000, (1024, 98, 65536, False, False, 0, False)),
    (3, 1, 1, (256, 1, 1, True, True, 12, True)),
])
def test_launch_plan(p, n, a, want):
    plan = ns._launch_plan(p, n, a)
    assert tuple(plan) == want
    assert plan.threads * plan.per >= n and plan.a_pad >= a and plan.a_pad & (plan.a_pad - 1) == 0
    assert plan.a_pad < 2 * a or plan.a_pad == 1
    assert plan.smem <= ns.SMEM_MAX


def test_launch_plan_takes_each_branch_at_its_own_shapes():
    """Every (keys in shared memory, survivors in shared memory, placed by
    rank) the kernel has, each at shapes where the plan itself takes it; the
    survivors placed by rank only in shared memory (A ≤ 256)."""
    shapes = [(256, 1000, 50), (64, 1000, 300), (2, 60000, 50), (2, 60000, 3000), (1, 40000, 20000),
              (1, 60000, 20000)]
    plans = [ns._launch_plan(*shape) for shape in shapes]
    branches = [(plan.keys_shared, plan.cands_shared, plan.rank_sort) for plan in plans]
    assert branches == [(True, True, True), (True, True, False), (False, True, True), (False, True, False),
                        (True, False, False), (False, False, False)]
    assert ns._launch_plan(1, 1000, 256).rank_sort and not ns._launch_plan(1, 1000, 257).rank_sort


def test_kernel_work():
    ops, nbytes = ns.kernel_work(256, 1000, 50)
    assert ops == 3 * 256 * 1000 + 5 * 256 * 50
    assert nbytes == 8 * 256 * 1000 + 16 * 256 + 41 * 256 * 50 + 8 * 256
    assert ns.kernel_work(16, 16384, 64)[1] == 2_139_520


def test_roofline_counts_one_call_by_formula():
    rng = np.random.default_rng(5)
    args = _args(rng, rng.integers(0, 30, (3, 30)), 4)
    with roofline.counting() as count:
        ns.nqueens_sample(*args)
    ops, nbytes = ns.kernel_work(3, 30, 4)
    assert dict(count.kernels[ns.KERNEL_NAME]) == {"calls": 1, "flops": ops, "bytes": nbytes}
    assert (count.flops, count.bytes) == (ops, nbytes)


def test_wrapper_checks_its_inputs_and_counts_no_launch_on_the_cpu():
    rng = np.random.default_rng(6)
    args = list(_args(rng, rng.integers(0, 20, (2, 20)), 3))
    before = ns.nqueens_sample.launches
    ns.nqueens_sample(*args)
    assert ns.nqueens_sample.launches == before
    bad = {
        0: (args[0].double(), TypeError), 2: (args[2][:, :10], ValueError), 3: (args[3].int(), TypeError),
        5: (args[5].t().contiguous().t(), ValueError), 7: (args[7][:, :-1], ValueError),
        1: (args[1][:59], ValueError),
    }
    for i, (value, err) in bad.items():
        with pytest.raises(err):
            ns.nqueens_sample(*args[:i], value, *args[i + 1:])
    for a in (0, 21):
        with pytest.raises(ValueError, match="A must be"):
            ns.nqueens_sample(*args[:-1], a)


def test_the_library_builds_once_with_the_c_entry_it_declares(tmp_path, monkeypatch):
    compiled, loaded = [], []

    def run(cmd, **kwargs):
        compiled.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return nk.subprocess.CompletedProcess(cmd, 0, "", "")

    class Library:
        def __init__(self, path):
            loaded.append(path)
            self.nqueens_sample_launch = type("Entry", (), {})()

    monkeypatch.setattr(nk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nk.subprocess, "run", run)
    monkeypatch.setattr(nk.ctypes, "CDLL", Library)
    monkeypatch.setattr(ns, "_LIBRARY", nk.KernelLibrary(ns._SRC, tmp_path / ns._LIB_PATH.name, ns._LIBRARY.argtypes))
    fn = ns._LIBRARY.entry("nqueens_sample_launch")
    assert ns._LIBRARY.entry("nqueens_sample_launch") is fn and len(compiled) == len(loaded) == 1
    cmd = compiled[0]
    assert cmd[-1] == str(ns._SRC) and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1].startswith(str(ns._LIBRARY.lib) + f".{os.getpid()}.")
    assert ns._LIB_PATH == nk._BUILD_DIR / f"lib{ns.KERNEL_NAME}.so"
    src = ns._SRC.read_text()
    params = re.search(r'extern "C" int nqueens_sample_launch\(([^)]*)\)', src).group(1)
    assert [q.strip() for q in params.split(",")] == ["const long long* plan", "void* stream"]
    assert fn.argtypes == [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p] and fn.restype is ctypes.c_int
    assert int(re.search(r"kPlanLen = (\d+);", src).group(1)) == ns.PLAN_LEN
    assert int(re.search(r"kSmemMax = 232448 - (\d+);", src).group(1)) == 232_448 - ns.SMEM_MAX
    assert int(re.search(r"kRankMax = (\d+);", src).group(1)) == ns.RANK_MAX
    # The plan's layout: 10 launch entries, then 9 inputs, 6 outputs and 2 scratches, one pointer each.
    assert 10 + 9 + 6 + 2 == ns.PLAN_LEN
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 2, "", "error: no sm_90a"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ns._LIBRARY.build(force=True)


def test_pmc_takes_its_column_sample_from_one_k6_call_and_sorts_nothing_else(monkeypatch):
    """PMC's sampled step hands K6 its column scores as the conflicted count
    and takes the sample's columns, rows and removed terms (the columns'
    scores): no sort of its own, and the step of the chain before K6."""
    from constraint_solver_tpu_torch.models import nqueens_parallel as pmc
    from constraint_solver_tpu_torch.utils.draws import TorchDraws

    n, p, a = 40, 3, 6
    carry = pmc.pmc_init(n, TorchDraws("pmc-k6", p, "cpu"))
    table = tnq.default_log_weights(n)
    calls, mode = [], _Ops()
    inner = pmc.nqueens_sample

    def sample(*args, **kw):
        calls.append(args[-1])
        mode.muted = True
        try:
            out = inner(*args, **kw)
        finally:
            mode.muted = False
        assert torch.equal(out.removed, args[0].gather(1, out.cols))
        return out

    monkeypatch.setattr(pmc, "nqueens_sample", sample)
    active = torch.ones(p, dtype=torch.bool)
    with mode:
        got = pmc.pmc_step(carry, TorchDraws("pmc-k6-step", p, "cpu"), active, 0.5, a, table)
    assert calls == [a]
    assert not [op for op in mode.ops if "sort" in op or "topk" in op], mode.ops

    def old_sample(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a):
        c, *_ = _old_chain(cs, table, gumbel, num_cols, n_conflicted, rows, rc, dc, ac, a)
        r = rows.gather(1, c)
        return ns.Sample(c, c.to(torch.int32), r.to(torch.int32), cs.gather(1, c).contiguous(), None, None)

    monkeypatch.setattr(pmc, "nqueens_sample", old_sample)
    want = pmc.pmc_step(carry, TorchDraws("pmc-k6-step", p, "cpu"), active, 0.5, a, table)
    for x, y in zip(tnq.NQState(*got.state), tnq.NQState(*want.state)):
        assert torch.equal(x, y)
    assert torch.equal(got.score, want.score) and torch.equal(got.steps, want.steps)
