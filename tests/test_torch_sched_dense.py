"""K5, the roster's dense neighborhood (``ops/sched_dense.py``,
``csrc/sched_dense.cu``), on the CPU: the wrapper (its plain version on CPU
tensors) against the JAX package's ``neighborhood_dense`` on every output, its
launch plan, its work, its input checks, its roofline count and its library's
build (a faked compiler and ``ctypes``).  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2g).

Assignments come from ``numpy.random.default_rng(seed)``; both sides draw from
the same JAX keys (``tests/jax_key_draws.py``).  Equality is exact: every score
is a small integer held in float32, every fingerprint a uint32."""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu_torch.core.problem import Neighborhood
from constraint_solver_tpu_torch.models import scheduling as ts
from constraint_solver_tpu_torch.ops import fingerprint as fpk
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops import sched_dense as sd
from constraint_solver_tpu_torch.utils import roofline
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from jax_key_draws import JaxKeyDraws
from test_torch_scheduling import NB_CASES, _assert_nb_equal, _assignments, _jax_neighborhood, _specs


def _wrapper_against_jax(name, p=4, seed=0, **kw):
    """The JAX dense neighborhood of random assignments, and ``sched_dense``
    called on them with the draws the port's proposer takes from the same keys."""
    jspec, tspec = _specs(name)
    jp = js.make_scheduling_problem(jspec, proposer="dense", **kw)
    tp = ts.make_scheduling_problem(tspec, proposer="dense", **kw)
    assign = _assignments(np.random.default_rng(seed), p, jspec)
    keys = jax.random.split(jax.random.key(seed + 100), p)
    k_nb = jax.vmap(jax.random.split)(keys)[:, 1]  # the descent's split
    nb_j = _jax_neighborhood(jp)(jnp.asarray(assign), k_nb)
    draws = JaxKeyDraws(keys)
    draws._ls_key = keys
    days = tspec.num_days
    n_rand = kw.get("n_rand_swaps", 64) if days >= 2 else 0
    n_off = 4 if days >= 15 else 0
    dr = draws.dense_swaps(n_rand, n_off, days, torch.ones(p, dtype=torch.bool))
    ta = torch.from_numpy(assign).long()
    out = sd.sched_dense(ta, tp.score(ta), ts.make_tables(tspec, "cpu"), tspec.start_weekday,
                         dr.rs_d1, dr.rs_off, dr.delta)
    nb_t = Neighborhood(scores=out.scores, moves=ts.SchedMoves(out.is_swap, out.d1, out.d2, out.new_emp),
                        valid=out.valid, fp_deltas=out.fp_deltas)
    return nb_j, nb_t, out


@pytest.mark.parametrize("name, p, n_rand", [(name, 4, 16) for name in NB_CASES]
                         + [("42d5e", 4, 0), ("365d20e", 2, 32)])
def test_wrapper_matches_jax_on_every_output(name, p, n_rand):
    """The NB cases (14d2e and 9d3e have no diagonals), one with no random
    swaps and the roster's 365 x 20 at P = 2."""
    nb_j, nb_t, out = _wrapper_against_jax(name, p=p, n_rand_swaps=n_rand)
    _assert_nb_equal(nb_j, nb_t)
    days, emps = _specs(name)[1].num_days, _specs(name)[1].num_employees
    assert out.valid.shape == (p, days * emps + n_rand + (4 * days if days >= 15 else 0))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", [(64, 365, 20, 256, 4), (128, 730, 40, 256, 4), (8, 31, 7, 16, 4)])
def test_launch_plan_covers_every_candidate_once(shape, sms):
    """The plan's blocks, walked as ``csrc/sched_dense.cu`` walks them, write
    each candidate of each lane once; tiles stay within the shared memory's
    counts; the grid fills the card where a tile can be halved."""
    p, d, e, n_rand, n_off = shape
    plan = sd._launch_plan(p, d, e, n_rand, n_off, sms)
    assert plan is sd._launch_plan(p, d, e, n_rand, n_off, sms)  # a pure function, cached
    assert 1 <= plan.tile <= sd.MAX_TILE and (plan.tile + 13) * e <= sd.MAX_COUNTS
    assert plan.grid == p * (plan.swap_blocks + plan.tiles) and plan.diag_grid == p * plan.diag_blocks
    written = np.zeros((p, d * e + n_rand + n_off * d), np.int64)
    swaps = p * plan.swap_blocks
    for b in range(plan.grid):
        if b < swaps:
            lane, chunk = divmod(b, plan.swap_blocks)
            ks = np.arange(chunk * sd.THREADS, min(n_rand, (chunk + 1) * sd.THREADS))
            written[lane, d * e + ks] += 1
        else:
            lane, tile = divmod(b - swaps, plan.tiles)
            days = np.arange(tile * plan.tile, min(d, (tile + 1) * plan.tile))
            written[lane, (days[:, None] * e + np.arange(e)).ravel()] += 1
    for b in range(plan.diag_grid):
        lane, chunk = divmod(b, plan.diag_blocks)
        slots = np.arange(chunk * sd.THREADS, min(n_off * d, (chunk + 1) * sd.THREADS))
        written[lane, d * e + n_rand + slots] += 1
    assert (written == 1).all()
    if plan.tile > 1 and -(-plan.tile // 2) * e >= sd.MIN_CELLS:
        assert p * plan.tiles >= 2 * sms
    want = {(64, 365, 20, 256, 4): (26, 15, 1, 6), (128, 730, 40, 256, 4): (13, 57, 1, 12),
            (8, 31, 7, 16, 4): (31, 1, 1, 1)}[shape]
    assert (plan.tile, plan.tiles, plan.swap_blocks, plan.diag_blocks) == want


@pytest.mark.parametrize("name, p, n_rand", [("365d20e", 2, 32), ("14d2e", 3, 16), ("42d5e", 2, 0)])
def test_kernel_work_counts_each_input_and_output_once(name, p, n_rand):
    tspec = _specs(name)[1]
    d, e = tspec.num_days, tspec.num_employees
    n_off = 4 if d >= 15 else 0
    draws = TorchDraws(name, p, "cpu")
    dr = draws.dense_swaps(n_rand, n_off, d, torch.ones(p, dtype=torch.bool))
    a = ts.make_scheduling_problem(tspec).init(draws)
    cur = ts.make_scheduling_problem(tspec).score(a)
    tables = ts.make_tables(tspec, "cpu")
    out = sd.sched_dense(a, cur, tables, tspec.start_weekday, dr.rs_d1, dr.rs_off, dr.delta)
    inputs = (a, cur, tables.holiday_de, dr.rs_d1, dr.rs_off, dr.delta)
    ops, nbytes = sd.kernel_work(p, d, e, n_rand, n_off)
    assert nbytes == sum(t.nbytes for t in inputs) + sum(t.nbytes for t in out)
    assert sum(t.nbytes for t in out) == sd.OUT_BYTES * out.valid.numel()
    assert ops > 0 and ops / 67e12 < nbytes / 3.35e12  # bytes bound it


def test_roofline_counts_one_k5_call_and_no_k2a_inside_it():
    tspec = _specs("31d7e-hol")[1]
    problem = ts.make_scheduling_problem(tspec, proposer="dense", n_rand_swaps=16)
    draws = TorchDraws("roofline", 3, "cpu")
    a = problem.init(draws)
    with roofline.counting() as count:
        problem.neighborhood(a, problem.score(a), draws, torch.ones(3, dtype=torch.bool))
    work = sd.kernel_work(3, 31, 7, 16, 4)
    assert dict(count.kernels[sd.KERNEL_NAME]) == {"calls": 1, "flops": work[0], "bytes": work[1]}
    assert fpk.HASH_KERNEL not in count.kernels


def test_wrapper_checks_its_inputs():
    tspec = _specs("31d7e-hol")[1]
    draws = TorchDraws("checks", 2, "cpu")
    dr = draws.dense_swaps(8, 4, 31, torch.ones(2, dtype=torch.bool))
    a = ts.make_scheduling_problem(tspec).init(draws)
    args = [a, ts.make_scheduling_problem(tspec).score(a), ts.make_tables(tspec, "cpu"), tspec.start_weekday,
            dr.rs_d1, dr.rs_off, dr.delta]
    sd.sched_dense(*args)
    for i, bad, err in ((0, a.int(), TypeError), (0, a[:, :30], ValueError), (0, a.t().contiguous().t(), ValueError),
                        (1, args[1].double(), TypeError), (4, dr.rs_d1[:, :4], ValueError), (3, 7, ValueError)):
        with pytest.raises(err):
            sd.sched_dense(*args[:i], bad, *args[i + 1:])
    assert sd.sched_dense.launches == 0  # the CPU runs the plain version: no launch


def test_both_kernel_files_share_the_hash():
    """K2 and K5 hash through one device function (``csrc/fp_hash.cuh``), so
    their fingerprints agree bit for bit; neither source defines its own."""
    csrc = sd._SRC.parent
    header = (csrc / "fp_hash.cuh").read_text()
    assert "uint32_t mix32(uint32_t h)" in header and "0x9E3779B9u" in header and "0x85EBCA77u" in header
    for src in (csrc / "fingerprint.cu", sd._SRC):
        text = src.read_text()
        assert '#include "fp_hash.cuh"' in text and "uint32_t mix32(uint32_t h)" not in text
        assert "0x9E3779B9u" not in text


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    compiled, loaded = [], []

    def run(cmd, **kwargs):
        compiled.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return nk.subprocess.CompletedProcess(cmd, 0, "", "")

    class Library:
        def __init__(self, path):
            loaded.append(path)
            self.sched_dense_launch = type("Entry", (), {})()

    monkeypatch.setattr(nk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nk.subprocess, "run", run)
    monkeypatch.setattr(nk.ctypes, "CDLL", Library)
    monkeypatch.setattr(sd, "_LIBRARY", nk.KernelLibrary(sd._SRC, tmp_path / sd._LIB_PATH.name, sd._LIBRARY.argtypes))
    return compiled, loaded


def test_the_library_builds_once_with_the_c_entry_it_declares(fake_toolchain):
    compiled, loaded = fake_toolchain
    fn = sd._LIBRARY.entry("sched_dense_launch")
    assert sd._LIBRARY.entry("sched_dense_launch") is fn and len(compiled) == len(loaded) == 1
    cmd = compiled[0]
    assert cmd[-1] == str(sd._SRC) and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1].startswith(str(sd._LIBRARY.lib) + f".{os.getpid()}.")
    assert fn.restype is ctypes.c_int and fn.argtypes == sd._ARGS
    src = sd._SRC.read_text()
    assert re.search(r'extern "C" int sched_dense_launch\(const long long\* plan, void\* stream\)', src)
    assert sd._LIB_PATH == nk._BUILD_DIR / f"lib{sd.KERNEL_NAME}.so"
    consts = {name: int(re.search(rf"{name} = (\d+);", src).group(1))
              for name in ("kThreads", "kMaxDays", "kMaxEmps", "kMaxTile", "kMaxCounts", "kPlanLen")}
    assert consts == {"kThreads": sd.THREADS, "kMaxDays": sd.MAX_DAYS, "kMaxEmps": sd.MAX_EMPS,
                      "kMaxTile": sd.MAX_TILE, "kMaxCounts": sd.MAX_COUNTS, "kPlanLen": sd.PLAN_LEN}


def test_the_library_is_rebuilt_when_the_shared_header_is_newer(fake_toolchain):
    compiled, _ = fake_toolchain
    sd.build_library()
    assert sd.build_library() == "" and len(compiled) == 1
    lib = sd._LIBRARY.lib
    os.utime(lib, (0, (sd._SRC.parent / "fp_hash.cuh").stat().st_mtime - 1))
    sd.build_library()
    assert len(compiled) == 2


def test_a_failed_build_raises(fake_toolchain, monkeypatch):
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 2, "", "error: no sm_90a"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sd._LIBRARY.entry("sched_dense_launch")
    assert sd._LIBRARY.entries is None
