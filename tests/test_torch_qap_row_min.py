"""QAP's swap row minimum, K1 (``ops/qap_row_min.py``), on the CPU.

The plain version must give the JAX package's compact and incremental
neighborhoods (``rmin``, the partners and ``valid``) on integer instances made
from a numpy seed, with ties going to the smaller partner and row n−1 giving
(inf, 0); and it must equal the port's previous eager chain bit for bit on
float instances, NaN and ±inf included, since the CUDA kernel is held to it bit
for bit on the card (``tests/test_torch_cuda.py``).  The wrapper checks its
inputs, takes the plain version for CPU tensors, counts by formula under
``roofline``, and builds its library once or raises; the compact and
incremental neighborhoods reach it."""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from constraint_solver_tpu.models import qap as jq
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import qap as tq
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops import qap_row_min as qrm
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils import roofline as rl
from constraint_solver_tpu_torch.utils.draws import TorchDraws

P = 3


def _state(n, p, seed, max_val=10):
    """(flow, p, G, H) as numpy arrays: F of ``QAPSpec.random`` (the two
    packages draw the same instance), p random permutations, G = D[p][:, p]
    and H = F G, exact in float32."""
    flow, dist = jq.QAPSpec.random(n, seed=seed, max_val=max_val).arrays()
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(n) for _ in range(p)])
    g = np.stack([dist[np.ix_(q, q)] for q in perms]).astype(np.float32)
    h = (flow.astype(np.float64) @ g.astype(np.float64)).astype(np.float32)
    return flow, perms, g, h


def _jax_neighborhood(mode, n, seed, perms, g, h, max_val=10):
    spec = jq.QAPSpec.random(n, seed=seed, max_val=max_val)
    key = jax.random.key(0)
    if mode == "compact":
        jp = jq.make_qap_problem(spec, compact=True)
        return jax.vmap(lambda q: jp.neighborhood(q, jp.score(q), key))(jnp.asarray(perms, jnp.int32))
    jp = jq.make_qap_problem(spec, incremental=True)
    st = jq.QAPState(jnp.asarray(perms, jnp.int32), jnp.asarray(g), jnp.asarray(h))
    return jax.vmap(lambda s: jp.neighborhood(s, jp.score(s), key))(st)


def _cur(flow, g):
    """Each lane's cost, float32[P] (the port's ``score``)."""
    return (torch.from_numpy(flow) * torch.from_numpy(g)).sum(dim=(1, 2))


@pytest.mark.parametrize("mode", ["compact", "incremental"])
@pytest.mark.parametrize("n", [7, 64, 130])
def test_plain_version_equals_the_jax_neighborhoods(mode, n):
    flow, perms, g, h = _state(n, P, seed=n)
    jnb = _jax_neighborhood(mode, n, n, perms, g, h)
    rmin, rarg = qrm.qap_swap_row_min(torch.from_numpy(h), torch.from_numpy(g), torch.from_numpy(flow),
                                      _cur(flow, g))
    assert rmin.dtype == torch.float32 and rarg.dtype == torch.int64
    np.testing.assert_array_equal(rmin.numpy(), np.asarray(jnb.scores)[..., 0])
    np.testing.assert_array_equal(rarg.numpy(), np.asarray(jnb.moves[1]))
    np.testing.assert_array_equal(torch.isfinite(rmin).numpy(), np.asarray(jnb.valid))
    assert rmin[:, -1].isinf().all() and (rarg[:, -1] == 0).all()


def test_ties_go_to_the_smaller_partner():
    """G and H of one or two values make most rows' minima tie; the JAX
    package's incremental neighborhood, a float64 numpy first argmin and the
    plain version agree, and row n−1 gives (inf, 0)."""
    n = 40
    flow, perms, _, _ = _state(n, P, seed=1, max_val=1)
    rng = np.random.default_rng(7)
    g = rng.integers(0, 2, (P, n, n)).astype(np.float32)
    h = rng.integers(0, 2, (P, n, n)).astype(np.float32)
    cur = _cur(flow, g)
    hd = np.diagonal(h, axis1=1, axis2=2).astype(np.float64)
    delta = 2 * (h + h.transpose(0, 2, 1) - hd[:, :, None] - hd[:, None, :] + 2 * flow * g)
    w = cur.numpy()[:, None, None] + delta
    w = np.where(np.triu(np.ones((n, n), bool), 1), w, np.inf)
    ties = (w == w.min(axis=2, keepdims=True)).sum(axis=2)[:, :-1]
    assert (ties >= 2).mean() > 0.5, "the instance plants too few ties"
    rmin, rarg = qrm.qap_swap_row_min(torch.from_numpy(h), torch.from_numpy(g), torch.from_numpy(flow), cur)
    jnb = _jax_neighborhood("incremental", n, 1, perms, g, h, max_val=1)
    np.testing.assert_array_equal(rarg.numpy(), np.argmin(w, axis=2))
    np.testing.assert_array_equal(rarg.numpy(), np.asarray(jnb.moves[1]))
    np.testing.assert_array_equal(rmin.numpy(), np.asarray(jnb.scores)[..., 0])
    assert torch.equal(rmin[:, -1], torch.full((P,), torch.inf)) and (rarg[:, -1] == 0).all()


def _previous_chain(h, g, flow, cur_score):
    """The port's eager chain before K1: ``row_min(cur_score, swap_deltas(h, g))``."""
    n = h.shape[1]
    hd = torch.diagonal(h, dim1=1, dim2=2)
    delta = 2.0 * (h + h.transpose(1, 2) - hd[:, :, None] - hd[:, None, :] + 2.0 * flow * g)
    iota = torch.arange(n)
    upper = iota[:, None] < iota[None, :]
    w = torch.where(upper, cur_score[:, 0, None, None] + delta, torch.inf)
    return torch.min(w, dim=2)


@pytest.mark.parametrize("plant", ["none", "nan", "inf"])
def test_plain_version_equals_the_previous_chain_on_floats(plant):
    """Non-integer floats (the operations round), with a NaN or a ±inf planted
    in a few rows: rmin's bits and rarg equal the previous chain's."""
    n = 50
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(0.0, 1e3, (P, n, n)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0.0, 1.0, (P, n, n)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(0.0, 10.0, (n, n)).astype(np.float32))
    cur_score = torch.from_numpy(np.stack([rng.normal(1e5, 1e3, P), np.zeros(P)], 1).astype(np.float32))
    if plant == "nan":
        g[0, 3, 10] = g[0, 3, 20] = h[1, 30, 5] = torch.nan  # row 3 twice; row 5 through H's transpose
        g[2, 8, 2] = torch.nan  # below the diagonal: masked
    elif plant == "inf":
        h[0, 4, 9] = torch.inf
        h[1, 6, 12] = -torch.inf
        flow[7, 30] = torch.inf  # with G's sign: ±inf in every lane's row 7
    rmin, rarg = qrm.qap_swap_row_min(h, g, flow, cur_score[:, 0])
    want_min, want_arg = _previous_chain(h, g, flow, cur_score)
    assert torch.equal(rmin.view(torch.int32), want_min.view(torch.int32)) and torch.equal(rarg, want_arg)
    if plant == "nan":
        assert rmin[0, 3].isnan() and int(rarg[0, 3]) == 10 and rmin[1, 5].isnan() and int(rarg[1, 5]) == 30
        assert not rmin[2, 8].isnan()


def test_wrapper_checks_its_inputs():
    n = 8
    h, g, flow = torch.zeros(2, n, n), torch.zeros(2, n, n), torch.zeros(n, n)
    cur = torch.zeros(2)
    with pytest.raises(TypeError):
        qrm.qap_swap_row_min(h.double(), g, flow, cur)
    with pytest.raises(TypeError):
        qrm.qap_swap_row_min(h, g, flow, cur.double())
    with pytest.raises(ValueError):
        qrm.qap_swap_row_min(h[0], g, flow, cur)  # not [P, n, n]
    with pytest.raises(ValueError):
        qrm.qap_swap_row_min(h, g[:, :, :-1], flow, cur)
    with pytest.raises(ValueError):
        qrm.qap_swap_row_min(h, g, flow, torch.zeros(3))
    with pytest.raises(ValueError):
        qrm.qap_swap_row_min(h.transpose(1, 2), g, flow, cur)  # not contiguous
    with pytest.raises(ValueError):
        qrm.qap_swap_row_min(h, g, flow.t(), cur)
    with pytest.raises(ValueError):
        qrm.qap_swap_row_min(h, g.to("meta"), flow, cur)  # two devices
    with pytest.raises(ValueError, match="no kernel for device meta"):
        qrm.qap_swap_row_min(*(t.to("meta") for t in (h, g, flow, cur)))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """No launch on the CPU: the plain version's result, a strided ``cur``
    taken as it is, and the counters untouched."""
    monkeypatch.setattr(qrm, "_launcher", lambda: pytest.fail("the CPU path reached the kernel"))
    flow, _, g, h = _state(16, 2, seed=4)
    cur_score = torch.stack([_cur(flow, g), torch.zeros(2)], dim=1)
    args = (torch.from_numpy(h), torch.from_numpy(g), torch.from_numpy(flow))
    before = qrm.qap_swap_row_min.launches
    got = qrm.qap_swap_row_min(*args, cur_score[:, 0])
    want = qrm.qap_swap_row_min_ref(*args, cur_score[:, 0].contiguous())
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert qrm.qap_swap_row_min.launches == before


def test_kernel_work_is_the_formula():
    p, n = 4, 4096
    ops, nbytes = qrm.kernel_work(p, n)
    pairs = n * (n - 1) // 2
    assert ops == 9 * p * pairs
    # H whole, G's and F's strict upper triangles and cur read; rmin and rarg written.
    assert nbytes == 4 * p * n * n + 4 * p * pairs + 4 * pairs + 4 * p + (4 + 8) * p * n
    assert round(nbytes / 1e6, 1) == 436.4 and round(nbytes / 3.35e12 * 1e3, 3) == 0.130
    assert qrm.kernel_work(1, 1) == (0, 4 + 4 + 12)


class _Shapes(TorchDispatchMode):
    """The output shapes of the aten ops that ``count`` counts (not muted)."""

    def __init__(self, count):
        super().__init__()
        self.count, self.seen = count, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.count._muted and isinstance(out, torch.Tensor):
            self.seen.append((str(func), tuple(out.shape)))
        return out


def test_roofline_counts_k1_once_per_descent_iteration_and_no_chain_op():
    n, p = 64, 4
    problem = tq.make_qap_problem(tq.QAPSpec.random(n, seed=0), incremental=True)
    calls = []

    def counted(*args):
        calls.append(1)
        return problem.neighborhood(*args)

    config = SolverConfig(seed="k1-roofline", local_search_max_iterations=20, best_solutions_capacity=4,
                          all_solutions_capacity=32)
    solver = PopulationSolver(problem._replace(neighborhood=counted), config, population=p, device="cpu")
    solver.run(max_rounds=1, chunk=1)
    calls.clear()
    r = solver.roofline(chunk=1)
    k1 = r["kernels"][qrm.KERNEL_NAME]
    assert len(calls) > 0 and k1["calls"] == len(calls)
    assert (k1["flops"], k1["bytes"]) == tuple(len(calls) * x for x in qrm.kernel_work(p, n))
    # One neighborhood under the count: no [P, n, n] op of the chain is counted.
    st = solver.state.current_state
    with rl.counting() as count, _Shapes(count) as shapes:
        on = torch.ones(p, dtype=torch.bool)
        problem.neighborhood(st, solver.state.current_score, TorchDraws("k1", p, "cpu"), on)
    assert dict(count.kernels[qrm.KERNEL_NAME]) == {"calls": 1, "flops": qrm.kernel_work(p, n)[0],
                                                     "bytes": qrm.kernel_work(p, n)[1]}
    assert shapes.seen and not [s for s in shapes.seen if s[1] == (p, n, n)]


@pytest.mark.parametrize("mode", ["dense", "compact", "incremental"])
def test_neighborhoods_reach_the_wrapper(mode, monkeypatch):
    """The compact and incremental neighborhoods call K1's wrapper once, the
    dense one never (it takes no row minimum)."""
    calls = []
    wrapper = qrm.qap_swap_row_min
    monkeypatch.setattr(qrm, "qap_swap_row_min", lambda *a: calls.append(a) or wrapper(*a))
    kw = {"dense": {}, "compact": {"compact": True}, "incremental": {"incremental": True}}[mode]
    problem = tq.make_qap_problem(tq.QAPSpec.random(12, seed=2), **kw)
    draws = TorchDraws("k1", 2, "cpu")
    state = problem.init(draws)
    problem.neighborhood(state, problem.score(state), draws, torch.ones(2, dtype=torch.bool))
    assert len(calls) == (0 if mode == "dense" else 1)
    if calls:
        h, g, flow, cur = calls[0]
        assert h.shape == g.shape == (2, 12, 12) and flow.shape == (12, 12) and cur.shape == (2,)


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``nvcc`` and ``ctypes`` replaced by recorders, the library in ``tmp_path``."""
    compiled = []

    class Library:
        def __init__(self, path):
            self.qap_row_min_launch = type("Entry", (), {})()
            self.qap_row_min_init = type("Entry", (), {})()

    monkeypatch.setattr(nk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nk.ctypes, "CDLL", Library)
    monkeypatch.setattr(qrm, "_LIB_PATH", tmp_path / "libqap_row_min.so")
    monkeypatch.setattr(qrm, "_launch_fn", None)
    monkeypatch.setattr(qrm, "_init_fn", None)
    return compiled


def test_launcher_builds_once_with_the_c_signature(fake_build, monkeypatch):
    def run(cmd, **kwargs):
        fake_build.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return nk.subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(nk.subprocess, "run", run)
    fn = qrm._launcher()
    assert qrm._launcher() is fn and len(fake_build) == 1
    assert fake_build[0][-1] == str(qrm._SRC) and "arch=compute_90a,code=sm_90a" in fake_build[0]
    # The ctypes argument list follows the C entry's parameters, type for type.
    src = qrm._SRC.read_text()
    params = re.search(r'extern "C" int qap_row_min_launch\(([^)]*)\)', src).group(1).split(",")
    kinds = {"void*": ctypes.c_void_p, "longlong": ctypes.c_longlong, "int": ctypes.c_int}
    want = [kinds[re.sub(r"const|\s|\b[a-z_]+$", "", q.strip())] for q in params]
    assert list(fn.argtypes) == want and len(want) == 17
    init = re.search(r'extern "C" int qap_row_min_init\(([^)]*)\)', src).group(1)
    assert init.strip() == "" and qrm._init_fn.argtypes == [] and qrm._init_fn.restype is ctypes.c_int


def test_a_failed_build_raises(fake_build, monkeypatch):
    monkeypatch.setattr(nk.subprocess, "run",
                        lambda cmd, **kw: nk.subprocess.CompletedProcess(cmd, 2, "", "error: no sm_90a"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        qrm._launcher()
    assert qrm._launch_fn is None
