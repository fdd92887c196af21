"""The N-Queens factory's last JAX options in the PyTorch port:
``col_sampling="approx"`` and the matrix forms of the candidate block,
``block_impl="mxu_conv"`` and ``"mxu_toeplitz"`` (``models/nqueens.py``).

- ``matrix_block`` against the kernel's plain version on the same inputs;
- each matrix form's neighborhood against the JAX package's same form and the
  port's ``"slice"`` (scores, valid, ``hint_idx``, ``n_valid``), from the same
  JAX keys (``tests/jax_key_draws.py``);
- ``PopulationSolver`` trajectories with ``"approx"`` and with each matrix
  form against the JAX package's same option, whose ``approx_max_k`` on the
  CPU returns ``lax.top_k``'s indices;
- which block runs (the JAX package's precedence: a truthy ``use_pallas`` or
  ``"slice"`` takes the kernel wrapper), and the matrix forms replayed by
  ``tests/test_torch_graphs.py``'s stand-in graph, which raises on a host read
  inside a capture.

Equality is exact: every score is a small integer held in float32.  The card
holds the matrix forms against the CUDA kernel (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 4d).
"""

import jax
import numpy as np
import pytest
import torch

from constraint_solver_tpu.core.ils import SolverConfig as JConfig
from constraint_solver_tpu.models import nqueens as jnq
from constraint_solver_tpu.parallel import population as jpop
from constraint_solver_tpu.utils.seeding import seed_string_to_key
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.models import nqueens as tnq
from constraint_solver_tpu_torch.ops import nqueens_kernel as tk
from constraint_solver_tpu_torch.parallel.population import PopulationSolver
from constraint_solver_tpu_torch.utils.convert import from_reference, to_reference
from constraint_solver_tpu_torch.utils.draws import TorchDraws
from jax_key_draws import JaxKeyDraws, reference_log_weights
from test_torch_graphs import Forced, _config, replay_capturer, run_pair
from test_torch_nqueens import _assert_equal, _boards, _jax_state, _kernel_inputs, _near_solved

MATRIX = ("mxu_conv", "mxu_toeplitz")


@pytest.mark.parametrize("impl", MATRIX)
@pytest.mark.parametrize("p, a, n", [(3, 5, 16), (1, 8, 8), (4, 64, 64), (2, 1, 1), (1, 40, 40), (2, 7, 101)])
def test_matrix_block_matches_the_kernel_plain_version(impl, p, a, n):
    st, c, r, removed, cur = _kernel_inputs(np.random.default_rng(n + a), p, n, a)
    args = (st.rc, st.dc, st.ac, c, r, removed, cur)
    for want, got in zip(tk.nqueens_neighborhood_scores_ref(*args), tnq.matrix_block(impl, *args), strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_matrix_block_takes_only_the_matrix_forms():
    st, c, r, removed, cur = _kernel_inputs(np.random.default_rng(0), 2, 8, 3)
    with pytest.raises(ValueError, match="'slice' is not a matrix form"):
        tnq.matrix_block("slice", st.rc, st.dc, st.ac, c, r, removed, cur)


def _neighborhoods(n, a, kind, jax_kw, port_kws):
    """The JAX package's neighborhood with ``jax_kw`` and the port's with each
    of ``port_kws``, from the same boards and keys."""
    rng = np.random.default_rng(n + (a or 0))
    p = 5
    boards = _near_solved(rng, p, n) if kind == "near" else _boards(rng, p, n, permutation=kind == "perm")
    jp = jnq.make_nqueens_problem(n, sample_cols=a, **jax_kw)
    jst = _jax_state(boards)
    keys = jax.random.split(jax.random.key(n), p)
    k_nb = jax.vmap(jax.random.split)(keys)[:, 1]  # the descent's split
    want = jax.jit(jax.vmap(jp.neighborhood))(jst, jax.vmap(jp.score)(jst), k_nb)
    got = []
    for kw in port_kws:
        tp = tnq.make_nqueens_problem(n, sample_cols=a, log_weights=reference_log_weights(n), **kw)
        draws = JaxKeyDraws(keys)
        draws._ls_key = keys
        tst = from_reference(jst, "cpu")
        got.append(tp.neighborhood(tst, tp.score(tst), draws, torch.ones(p, dtype=torch.bool)))
    return want, got


NEIGHBORHOODS = pytest.mark.parametrize(
    "n, a, kind", [(10, None, "random"), (24, 4, "perm"), (12, 6, "near")]
)


@pytest.mark.parametrize("impl", MATRIX)
@NEIGHBORHOODS
def test_matrix_neighborhood_matches_jax_and_slice(impl, n, a, kind):
    want, (got, slice_) = _neighborhoods(n, a, kind, {"block_impl": impl}, [{"block_impl": impl}, {}])
    for nb in (got, slice_):
        _assert_equal(want.scores, nb.all_scores().numpy())
        _assert_equal(want.valid, nb.all_valid().numpy())
        _assert_equal(want.hint_idx, nb.hint_idx.numpy().astype(np.int32))
        _assert_equal(want.n_valid, nb.n_valid.numpy().astype(np.int32))


@NEIGHBORHOODS
def test_approx_neighborhood_matches_jax(n, a, kind):
    want, (got,) = _neighborhoods(n, a, kind, {"col_sampling": "approx"}, [{"col_sampling": "approx"}])
    _assert_equal(want.scores, got.all_scores().numpy())
    _assert_equal(want.hint_idx, got.hint_idx.numpy().astype(np.int32))
    _assert_equal(want.moves[0], got.moves.cols.repeat_interleave(n, dim=1).numpy().astype(np.int32))


N, P = 32, 4


@pytest.mark.parametrize(
    "option", [{"col_sampling": "approx"}, {"block_impl": "mxu_conv"}, {"block_impl": "mxu_toeplitz"}],
    ids=["approx", "mxu_conv", "mxu_toeplitz"],
)
def test_population_rounds_match_jax(option):
    """A few ``PopulationSolver`` rounds with the option, from the same keys,
    equal the JAX package's with the same option."""
    seed = f"options-{N}"
    kw = _config(seed, False)
    draws = JaxKeyDraws(jax.random.split(seed_string_to_key(seed), P))
    solver = PopulationSolver(
        tnq.make_nqueens_problem(N, log_weights=reference_log_weights(N), **option), SolverConfig(**kw),
        population=P, exchange_every=2, draws=draws, device="cpu",
    )
    jsolver = jpop.PopulationSolver(jnq.make_nqueens_problem(N, **option), JConfig(**kw), population=P, exchange_every=2)
    for _ in range(2):
        np.testing.assert_array_equal(solver.execute_chunk_traced(2), np.asarray(jsolver.execute_chunk_traced(2)))
    want, got = jsolver.state, to_reference(solver.state)
    for f in got._fields:
        for x, y in zip(jax.tree.leaves(getattr(want, f)), jax.tree.leaves(getattr(got, f)), strict=True):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f)


@pytest.mark.parametrize(
    "use_pallas, block_impl, kernel",
    [(False, "slice", True), (True, "slice", True), (True, "mxu_conv", True), ("interpret", "mxu_toeplitz", True),
     (False, "mxu_conv", False), (False, "mxu_toeplitz", False)],
)
def test_which_block_runs(monkeypatch, use_pallas, block_impl, kernel):
    """The JAX package's precedence: a truthy ``use_pallas``, or ``"slice"``,
    takes the kernel wrapper; otherwise the matrix form runs instead of it."""
    calls = []
    wrapper, matrix = tnq.nqueens_neighborhood_scores, tnq.matrix_block
    monkeypatch.setattr(tnq, "nqueens_neighborhood_scores", lambda *a: calls.append("kernel") or wrapper(*a))
    monkeypatch.setattr(tnq, "matrix_block", lambda impl, *a: calls.append(impl) or matrix(impl, *a))
    problem = tnq.make_nqueens_problem(16, use_pallas=use_pallas, block_impl=block_impl)
    assert problem.capturable
    draws = TorchDraws("which", 2, "cpu")
    st = problem.init(draws)
    problem.neighborhood(st, problem.score(st), draws, torch.ones(2, dtype=torch.bool))
    assert calls == (["kernel"] if kernel else [block_impl])


@pytest.mark.parametrize("impl", MATRIX)
def test_matrix_forms_replay_as_graphs(impl):
    """The matrix forms stay ``capturable``: with the stand-in graph (a host
    read inside a capture raises) the trajectory equals the eager loop's."""

    def make():
        return PopulationSolver(
            tnq.make_nqueens_problem(16, block_impl=impl), SolverConfig(**_config(f"replay-{impl}", False)),
            population=P, exchange_every=2, device="cpu",
        )

    graphs = Forced(capturer=replay_capturer)
    eager, graph = run_pair(make, graphs, chunks=2)
    (unit,) = graphs._units.values()
    assert unit._a.graph.replays > 1
    assert torch.equal(graph.draws.state_dict()["generator"], eager.draws.state_dict()["generator"])
