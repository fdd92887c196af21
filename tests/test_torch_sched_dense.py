"""K5, the roster's dense neighborhood (``ops/sched_dense.py``,
``csrc/sched_dense.cu``), on the CPU: the wrapper (its plain version on CPU
tensors) against the JAX package's ``neighborhood_dense`` on every output, its
launch plan, its work, its input checks, its roofline count and its library's
build (a faked compiler and ``ctypes``).  The kernel itself runs only on
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
@pytest.mark.parametrize("shape", [(64, 365, 20, 256, 4), (128, 730, 40, 256, 4), (8, 31, 7, 16, 4),
                                   (200, 31, 7, 16, 4), (1100, 15, 3, 4, 2), (3, 2, 2, 5, 0), (2, 1, 3, 0, 0),
                                   (1, 4096, 2, 16, 1), (1, 4096, 256, 16, 2), (2, 50, 256, 300, 2),
                                   (1, 40, 6, 2100, 4)])
def test_launch_plan_covers_every_candidate_once(shape, sms):
    """The plan's clusters, walked as ``csrc/sched_dense.cu`` walks them
    (block r of a lane: its days [D·r/S, D·(r+1)/S) chunk by chunk, its
    random swaps [R·r/S, R·(r+1)/S) a batch at a time, the diagonal slots of
    its days, its words [N·r/S, N·(r+1)/S) of the lane's days), write each
    candidate of each lane once, build each membership word and window flag
    word once, and find each diagonal's far day in the block that owns it;
    the cluster is as large as one wave allows, within the portable size and
    D; shared memory is the layout's, within 227 KB, the flags, the plane and
    the holiday rows in it as far as they fit, in that order.  Shapes: the
    roster's, 730 x 40, the reference CLI's, clusters of 2 and of 1 (many
    lanes), D smaller than the cluster the SMs ask for, one day, several
    chunks a block, flags, plane and holidays in global memory, the most
    employees, several batches of swaps."""
    p, d, e, n_rand, n_off = shape
    plan = sd._launch_plan(p, d, e, n_rand, n_off, sms)
    assert plan is sd._launch_plan(p, d, e, n_rand, n_off, sms)  # a pure function, cached
    s = plan.slices
    assert s == max(1, min(sd.MAX_SLICES, d, int(sd.WAVE_FILL * sd.BLOCKS_PER_SM * sms) // p)) and plan.grid == p * s
    assert plan.span == -(-d // s) and plan.chunk == min(plan.span, sd.MAX_CHUNK)
    assert plan.swap_batch == min(sd.THREADS, -(-n_rand // s))
    fits = lambda *where: sd._smem_bytes(d, e, s, plan.chunk, plan.span, n_off, plan.swap_batch, *where)  # noqa: E731
    assert plan.smem == fits(plan.flags_shared, plan.hol_shared, plan.plane_shared) <= sd.SMEM_MAX
    assert plan.flags_shared == (fits(True, False, False) <= sd.SMEM_MAX)
    assert plan.plane_shared == (fits(plan.flags_shared, False, True) <= sd.SMEM_MAX)
    assert plan.hol_shared == (fits(plan.flags_shared, True, plan.plane_shared) <= sd.SMEM_MAX)
    written = np.zeros((p, d * e + n_rand + n_off * d), np.int64)
    nw = -(-d // 32)
    words = np.zeros(nw, np.int64)
    for rank in range(s):  # every lane's cluster walks the same ranges
        lo, hi = d * rank // s, d * (rank + 1) // s
        assert 1 <= hi - lo <= plan.span
        for c0 in range(lo, hi, plan.chunk):
            written[:, c0 * e:min(hi, c0 + plan.chunk) * e] += 1
        r0, r1 = n_rand * rank // s, n_rand * (rank + 1) // s
        for b0 in range(r0, r1, max(1, plan.swap_batch)):  # no batch without swaps
            written[:, d * e + b0:d * e + min(r1, b0 + plan.swap_batch)] += 1
        for j in range(n_off):
            written[:, d * e + n_rand + j * d + lo:d * e + n_rand + j * d + hi] += 1
        k0, k1 = nw * rank // s, nw * (rank + 1) // s
        assert k1 - k0 + 1 <= -(-nw // s) + 1  # its membership words and the next fit its rows
        words[k0:k1] += 1
    assert (written == 1).all() and (words == 1).all()
    far = np.arange(d)
    owner = ((far + 1) * s - 1) // d  # the block a diagonal reads day far's plane from
    assert ((d * owner // s <= far) & (far < d * (owner + 1) // s)).all()
    want = {(64, 365, 20, 256, 4): (7, 53, 53, 37, 17968, True, True, True),
            (1, 4096, 256, 16, 2): (8, 512, 128, 2, 52416, False, False, False)}
    if sms == 132 and shape in want:
        assert (plan.slices, plan.span, plan.chunk, plan.swap_batch, plan.smem, plan.flags_shared,
                plan.plane_shared, plan.hol_shared) == want[shape]


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
            self.sched_dense_occupancy = type("Entry", (), {})()

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
    assert sd._LIBRARY.entry("sched_dense_occupancy").argtypes == sd._OCCUPANCY_ARGS
    consts = {name: int(re.search(rf"{name} = (\d+);", src).group(1))
              for name in ("kThreads", "kMinBlocks", "kMaxDays", "kMaxEmps", "kMaxSlices", "kMaxChunk", "kSmemMax",
                           "kPlanLen", "kDayFields", "kSwapFields")}
    assert consts == {"kThreads": sd.THREADS, "kMinBlocks": sd.BLOCKS_PER_SM, "kMaxDays": sd.MAX_DAYS,
                      "kMaxEmps": sd.MAX_EMPS, "kMaxSlices": sd.MAX_SLICES, "kMaxChunk": sd.MAX_CHUNK,
                      "kSmemMax": sd.SMEM_MAX, "kPlanLen": sd.PLAN_LEN, "kDayFields": sd.DAY_FIELDS,
                      "kSwapFields": sd.SWAP_FIELDS}
    assert "kListWords = kNp + 6" in src and "kNp = 3 * kLists" in src and "kLists = 9" in src
    assert "hMix0, hMix1, hOwn0, hOwn1, kHashFields" in src and "kF3 = 0, kG4 = 1, kF2 = 2, kG3 = 3, kFlags = 4" in src
    assert (sd.LIST_WORDS, sd.HASH_FIELDS, sd.FLAGS) == (3 * 9 + 6, 4, 4)


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
