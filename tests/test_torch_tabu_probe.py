"""K2a's ring form (``ops/fingerprint.hash_probe``, ``TabuRing.push_probe``) and
K2b's split plan, on the CPU.

On CPU tensors ``push_probe`` runs its plain version, the ring's own ``push``
and ``is_tabu``, which must give the JAX package's ``TabuRing.push`` and
``is_tabu`` (vmapped over lanes) bit for bit on every adversarial ring the card
is held to (``chip_smoke.py`` phase 2d): a fingerprint in several slots, a full
ring wrapping its head, expired and never-written slots against (0, 0), a push
already present, sums and counts that wrap int32, heads outside the ring, rings
of more than one shared-memory tile.  The kernels run only on the card
(``tests/test_torch_cuda.py -k "fingerprint or tabu"``); their plans are pure
functions of shapes, strides and dtypes, checked here against emulations of
the blocks' walks: every (lane, candidate) written by one thread, every ring
slot staged by one tile, every (row, position) of a split row hashed by one
block, the grid over the SMs where the plan promises it."""

import inspect
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core import history as jh
from constraint_solver_tpu_torch.core import local_search as tls
from constraint_solver_tpu_torch.core.history import TabuRing
from constraint_solver_tpu_torch.ops import fingerprint as fp
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.utils import roofline as rl

SMS = nk._SMS


def _ring(rng, p, t, fill, count=None, expiry=1000, head=None):
    """A ring as a descent leaves it: ``fill`` slots written, the rest never."""
    fps = rng.integers(0, 2**32, size=(p, t, 2))
    fps[:, fill:] = 0
    cnt = rng.integers(fill, fill + 50, size=p) if count is None else np.full(p, count)
    iters = np.full((p, t), -(2**31 - 1), dtype=np.int64)
    iters[:, :fill] = cnt[:, None] - rng.integers(0, 2 * expiry + 1, size=(p, min(fill, t)))
    hd = rng.integers(0, t, size=p) if head is None else np.full(p, head)
    i32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.int64).astype(np.int32))  # noqa: E731
    return TabuRing(torch.from_numpy(fps), i32(iters), i32(hd), i32(cnt), i32(np.full(p, expiry)))


def _cands(rng, ring, w, share):
    p, t = ring.fps.shape[:2]
    fresh = torch.from_numpy(rng.integers(0, 2**32, size=(p, w, 2)))
    src = torch.from_numpy(rng.integers(0, t, size=(p, w)))
    take = torch.from_numpy(rng.random((p, w)) < share)
    return torch.where(take[..., None], ring.fps[torch.arange(p)[:, None], src], fresh)


def _case(kind, rng):
    """(ring, push_fp, fps, base, deltas, valid) for one adversarial kind."""
    p, t = 5, 16
    fresh = torch.from_numpy(rng.integers(0, 2**32, size=(p, 2)))
    if kind == "pick":
        ring = _ring(rng, p, t, fill=12)
        return ring, torch.where(torch.from_numpy(rng.random((p, 1)) < 0.5), ring.fps[:, 3], fresh), \
            _cands(rng, ring, 1, 0.5), None, None, torch.from_numpy(rng.random((p, 1)) < 0.8)
    if kind == "retry":
        ring = _ring(rng, p, t, fill=12)
        return ring, None, _cands(rng, ring, 1, 0.5), None, None, torch.from_numpy(rng.random(p) < 0.5)[:, None]
    if kind == "exact filter":
        ring = _ring(rng, p, t, fill=t)
        deltas = _cands(rng, ring, 37, 0.3) ^ fresh[:, None, :]
        planes = torch.stack([deltas[..., 0], deltas[..., 1]]).permute(1, 2, 0)  # a strided [P, W, 2] view
        return ring, fresh, None, fresh, planes, torch.from_numpy(rng.random((p, 37)) < 0.9)
    if kind == "several slots":
        ring = _ring(rng, p, t, fill=t, count=100)
        dup = ring.fps[:, 5].clone()
        ring.fps[:, 9], ring.fps[:, 12] = dup, dup
        return ring, dup, dup[:, None, :].expand(p, 3, 2), None, None, None
    if kind == "full ring wraps":
        ring = _ring(rng, p, t, fill=t, count=100, head=t - 1)
        return ring, fresh, _cands(rng, ring, 20, 0.5), None, None, None
    if kind in ("never written", "never written, (0, 0) pushed"):
        ring = _ring(rng, p, t, fill=5, count=3000, expiry=10)
        zero = torch.zeros((p, 4, 2), dtype=torch.int64)
        zero[:, 1], zero[:, 2] = ring.fps[:, 0], ring.fps[:, 1]
        push = torch.zeros((p, 2), dtype=torch.int64) if "pushed" in kind else None
        return ring, push, zero, None, None, None
    if kind == "expiry wraps":
        ring = _ring(rng, p, t, fill=t, count=50, expiry=2**31 - 1)
        ring.iters[:, :8] = torch.tensor([5, -5, 2**31 - 1, -2**31, 0, 100, 49, 51], dtype=torch.int32)
        return ring, ring.fps[:, 2].clone(), ring.fps.clone(), None, None, None
    if kind == "count wraps":
        ring = _ring(rng, p, t, fill=t, count=2**31 - 1, expiry=3)
        ring.iters[:, :4] = torch.tensor([2**31 - 1, 2**31 - 2, -2**31, 2**31 - 4], dtype=torch.int32)
        return ring, fresh, ring.fps.clone(), None, None, None
    if kind.startswith("head"):
        ring = _ring(rng, p, t, fill=t, head=int(kind.split()[1]))
        return ring, fresh, _cands(rng, ring, 7, 0.5), None, None, None
    assert kind == "two tiles"
    ring = _ring(rng, 2, fp.PROBE_TILE + 7, fill=fp.PROBE_TILE, expiry=200)
    cur = fresh[:2]
    return ring, ring.fps[:, 600].clone(), None, cur, _cands(rng, ring, 30, 0.4) ^ cur[:, None, :], None


KINDS = ["pick", "retry", "exact filter", "several slots", "full ring wraps", "never written",
         "never written, (0, 0) pushed", "expiry wraps", "count wraps", f"head {2**31 - 1}", "head 19", "head -1",
         "two tiles"]


def _jax_ring(ring):
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))  # noqa: E731
    i32 = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    return jh.TabuRing(u32(ring.fps), i32(ring.iters), i32(ring.head), i32(ring.count), i32(ring.expiry))


@pytest.mark.parametrize("kind", KINDS)
def test_push_probe_equals_the_jax_push_and_is_tabu(kind):
    ring, push, fps, base, deltas, valid = _case(kind, np.random.default_rng(zlib.crc32(kind.encode())))
    got_ring, got = ring.push_probe(push, fps, base, deltas, valid)
    cands = fps if fps is not None else base[:, None, :] ^ deltas
    jring = _jax_ring(ring)
    if push is not None:
        jring = jax.vmap(jh.TabuRing.push)(jring, jnp.asarray(push.numpy().astype(np.uint32)))
    tabu = jax.vmap(jh.TabuRing.is_tabu)(jring, jnp.asarray(cands.numpy().astype(np.uint32)))
    want = np.asarray(tabu) if valid is None else np.asarray(valid.expand(tabu.shape).numpy() & ~np.asarray(tabu))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    for field in ("fps", "iters", "head", "count", "expiry"):
        np.testing.assert_array_equal(getattr(got_ring, field).numpy(), np.asarray(getattr(jring, field)), field)
    # The pushed ring's dtypes are the port's, and without a push it is the ring itself.
    assert (got_ring.fps.dtype, got_ring.iters.dtype, got_ring.count.dtype) == (torch.int64, torch.int32, torch.int32)
    assert push is not None or got_ring is ring


def test_cpu_tensors_take_the_plain_version_and_count_by_the_plan(monkeypatch):
    monkeypatch.setattr(fp._LIBRARY, "entry", lambda entry: pytest.fail("the CPU path reached the kernel"))
    ring, push, fps, base, deltas, valid = _case("exact filter", np.random.default_rng(1))
    before = fp.hash_probe.launches
    with rl.counting() as count:
        got = fp.hash_probe(ring, push, fps, base, deltas, valid)
    want = fp.hash_probe_ref(ring, push, fps, base, deltas, valid)
    assert all(torch.equal(a, b) for a, b in zip((*got[0], got[1]), (*want[0], want[1])))
    assert fp.hash_probe.launches == before
    plan = fp.probe_plan(ring, push, fps, base, deltas, valid)[0]
    assert dict(count.kernels[fp.PROBE_KERNEL]) == {"calls": 1, "flops": plan.work[0], "bytes": plan.work[1]}
    assert (count.flops, count.bytes) == plan.work  # the plain ops inside are not counted


def test_hash_probe_checks_its_operands():
    ring, push, fps, _, _, valid = _case("pick", np.random.default_rng(2))
    with pytest.raises(ValueError, match="fingerprints, or a base"):
        fp.hash_probe(ring, push, fps, base=push)
    with pytest.raises(ValueError, match="fingerprints, or a base"):
        fp.hash_probe(ring, push)
    with pytest.raises(ValueError, match="valid must be torch.bool"):
        fp.hash_probe(ring, push, fps, valid=valid.int())
    with pytest.raises(ValueError, match="candidates must be int64"):
        fp.hash_probe(ring, push, fps.int())
    with pytest.raises(ValueError, match="push_fp must be"):
        fp.hash_probe(ring, push[:2], fps)
    with pytest.raises(ValueError, match="iters must be torch.int32"):
        fp.hash_probe(ring._replace(iters=ring.iters.long()), push, fps)
    with pytest.raises(ValueError, match="no slot"):
        fp.hash_probe(ring._replace(fps=ring.fps[:, :0], iters=ring.iters[:, :0]), push, fps)


def test_the_descent_probes_the_ring_once_a_pick(monkeypatch):
    """``_begin`` pushes and checks in one ``push_probe``, each retry checks in
    one, and neither calls ``push`` or ``is_tabu`` itself."""
    from constraint_solver_tpu_torch.core.ils import SolverConfig
    from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem
    from constraint_solver_tpu_torch.parallel.population import PopulationSolver

    calls = []

    def push_probe(self, push_fp=None, fps=None, base=None, deltas=None, valid=None):
        calls.append(push_fp is not None)
        return fp.hash_probe(self, push_fp, fps, base, deltas, valid)

    monkeypatch.setattr(tls.TabuRing, "push_probe", push_probe)
    begun, retried = [], []
    monkeypatch.setattr(tls, "_begin", lambda *a, _f=tls._begin: begun.append(1) or _f(*a))
    monkeypatch.setattr(tls, "_retry", lambda *a, _f=tls._retry: retried.append(1) or _f(*a))
    for exact in (None, False):
        calls.clear(), begun.clear(), retried.clear()
        config = SolverConfig(seed="probe", local_search_max_iterations=6, best_solutions_capacity=2,
                              all_solutions_capacity=8, tabu_exact_filter=exact)
        PopulationSolver(make_nqueens_problem(12), config, population=3, device="cpu").run(max_rounds=2, chunk=2)
        assert calls.count(True) == len(begun) > 0 and calls.count(False) == len(retried)
    source = inspect.getsource(tls)
    assert ".push(" not in source and ".is_tabu(" not in source


# ---------------------------------------------------------------- the plans


def _probe_plan(p, w, t, push=True, base=True, valid=True):
    ring = TabuRing.create(p, t, 10, "cpu")
    fps = torch.zeros((p, w, 2), dtype=torch.int64)
    cur = torch.zeros((p, 2), dtype=torch.int64)
    return fp.probe_plan(ring, cur if push else None, None if base else fps, cur if base else None,
                         fps if base else None, torch.ones((p, w), dtype=torch.bool) if valid else None)[0]


@pytest.mark.parametrize("p, w, t", [(256, 1, 256), (16, 1, 256), (4, 1, 128), (64, 9016, 64), (8, 64, 64),
                                     (3, 700, 2500), (1, 1025, 1), (2, 0, 16), (300, 300, 8)])
def test_probe_plan_covers_every_candidate_and_slot_once(p, w, t):
    plan = _probe_plan(p, w, t)
    per, chunks = plan.per_thread, plan.chunks
    assert per in (1, 2, 4) and chunks == max(1, -(-w // (per * fp.THREADS)))
    # Blocks (lane, chunk), threads, and each thread's per candidates kThreads apart: each w once.
    seen = np.zeros((p, w), dtype=np.int64)
    for chunk in range(chunks):
        ws = chunk * per * fp.THREADS + np.arange(fp.THREADS)[:, None] + fp.THREADS * np.arange(per)[None, :]
        ws = ws[ws < w]
        seen[:, ws] += 1
    assert (seen == 1).all()
    # The ring's tiles: each slot staged once; a tile and its counters fit the static 48 KB.
    assert plan.tiles == -(-t // fp.PROBE_TILE)
    slots = np.concatenate([np.arange(t0, min(t, t0 + fp.PROBE_TILE)) for t0 in range(0, t, fp.PROBE_TILE)])
    assert np.array_equal(slots, np.arange(t)) and 8 * fp.PROBE_TILE + 8 <= 48 * 1024
    # More than one candidate a thread only where the grid still holds two blocks an SM.
    assert per == 1 or p * chunks >= 2 * SMS
    assert p * chunks < 2**31


def test_probe_plan_candidates_a_thread_at_the_solvers_shapes():
    assert [_probe_plan(p, 1, t).per_thread for p, t in ((256, 256), (16, 256), (4, 128))] == [1, 1, 1]
    roster = _probe_plan(64, 365 * 20 + 256 + 4 * 365, 64)
    assert (roster.per_thread, roster.chunks, roster.tiles) == (4, 9, 1) and 64 * roster.chunks >= 2 * SMS


def test_probe_plan_layout_and_work():
    p, w, t = 3, 5, 7
    ring = TabuRing.create(p, t, 10, "cpu")
    cur = torch.zeros((p, 2), dtype=torch.int64)
    deltas = torch.zeros((2, p, w), dtype=torch.int64).permute(1, 2, 0)  # strides (w, 1, p * w)
    valid = torch.ones((p, 1), dtype=torch.bool).expand(p, w)
    plan, ptrs, _ = fp.probe_plan(ring, cur, None, cur, deltas, valid)
    tpl = plan.template
    assert len(tpl) == fp.PROBE_PLAN_LEN and tpl[:5] == (p, w, t, 1, 1)
    assert tpl[5:9] == (0, 2 * t, 2, 1) and tpl[9:12] == (0, t, 1) and tpl[12:18] == (0, 1, 0, 1, 0, 1)
    assert tpl[18:21] == (0, 2, 1) and tpl[21:24] == (0, 2, 1)  # push and base, one tensor
    assert tpl[24:28] == (0, w, 1, p * w) and tpl[28:31] == (0, 1, 0) and tpl[31:] == (0,) * 5
    values = fp._probe_values(plan, {**ptrs, "out": 11})
    assert values[5] == ring.fps.data_ptr() and values[18] == values[21] == cur.data_ptr() and values[31] == 11
    assert values[24] == deltas.data_ptr() and values[28] == valid.data_ptr() and values[32] == 0
    # Bytes: the ring, the pushed fingerprint once (push and base alias), the deltas, valid's P elements,
    # the [P, W] output and the pushed ring; operations: two compares a candidate and slot, and the push's.
    nbytes = 16 * p * t + 4 * p * t + 3 * 4 * p + 16 * p + 16 * p * w + p + p * w + 20 * p * t + 8 * p
    assert plan.work == (2 * p * w * t + 2 * p * t, nbytes)
    apart = fp.probe_plan(ring, cur.clone(), None, cur, deltas, valid)[0]
    assert apart.work[1] == nbytes + 16 * p
    no_push = fp.probe_plan(ring, None, deltas, None, None, None)[0]
    assert no_push.work == (2 * p * w * t, 16 * p * t + 4 * p * t + 12 * p + 16 * p * w + p * w)


def test_plan_layouts_match_the_cuda_source():
    src = fp._SRC.read_text()
    assert f"kProbePlanLen == {fp.PROBE_PLAN_LEN}" in src and f"kRowsPlanLen == {fp.ROWS_PLAN_LEN}" in src
    assert max(fp._PROBE_SLOTS.values()) == fp.PROBE_PLAN_LEN - 1
    for name, at in fp._PROBE_SLOTS.items():  # each pointer where the C entry reads it
        assert f"plan[{at}]" in src, name


@pytest.mark.parametrize("rows, n", [(16, 16384), (4, 4096), (1, 1025), (3, 5000), (131, 2000), (132, 4096),
                                     (256, 1000), (64, 365), (1, 1024), (2, 1 << 20)])
def test_rows_plan_splits_a_few_long_rows_over_the_sms(rows, n):
    plan = fp._rows_plan((rows, n), (n, 1), torch.int32)
    if plan.warps_per_row < fp.WARPS or rows >= SMS:  # short rows, or enough of them: today's plan
        assert (plan.splits, plan.chunk, plan.grid) == (1, n, -(-rows // (fp.WARPS // plan.warps_per_row)))
        return
    assert plan.splits > 1 and plan.grid == rows * plan.splits
    assert plan.chunk >= fp.SPLIT_MIN and (plan.splits - 1) * plan.chunk < n <= plan.splits * plan.chunk
    # Every (row, position) hashed by one block: block b takes row b // splits, positions of part b % splits.
    seen = np.zeros((rows, n), dtype=np.int64)
    for b in range(plan.grid):
        j0 = (b % plan.splits) * plan.chunk
        seen[b // plan.splits, j0: min(n, j0 + plan.chunk)] += 1
    assert (seen == 1).all()
    assert plan.grid >= SMS or plan.splits == n // fp.SPLIT_MIN or -(-n // plan.chunk) == plan.splits
    if (rows, n) in ((16, 16384), (4, 4096)):
        assert plan.grid >= SMS
