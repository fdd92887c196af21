"""The port's five CLIs (``constraint_solver_tpu_torch.cli.*``) against the JAX
package's.

- Config parity: for the same argv, each port CLI builds the same solver as
  its JAX counterpart (the same ``SolverConfig`` fields, problem name and
  width, population, PMC arguments and QAP mode flags).  Both packages'
  ``Solver``, ``PopulationSolver`` and ``ParallelMinConflictsSolver`` are
  replaced by recorders that stop the CLI, so nothing is solved or compiled.
  The port's solvers get ``device="cuda"`` unless ``--device cpu`` is given.
- End to end on the CPU (``--device cpu``), mirroring ``tests/test_cli.py``,
  plus QAP (its host-oracle check runs) and a routed diagram SVG.
- Without a card, the default ``--device cuda`` raises: there is no fallback.
"""

import dataclasses
import importlib
import os

import pytest
import torch

from constraint_solver_tpu.cli import ackley as j_ackley
from constraint_solver_tpu.cli import diagram as j_diagram
from constraint_solver_tpu.cli import nqueens as j_nqueens
from constraint_solver_tpu.cli import qap as j_qap
from constraint_solver_tpu.cli import scheduling as j_scheduling
from constraint_solver_tpu_torch.cli import ackley, diagram, nqueens, qap, scheduling
from constraint_solver_tpu_torch.core.ils import SolverConfig
from constraint_solver_tpu_torch.utils.checkpoint import checkpoint_exists, checkpoint_path
from constraint_solver_tpu_torch.utils.printing import format_board

CLIS = {"nqueens": (j_nqueens, nqueens), "scheduling": (j_scheduling, scheduling), "qap": (j_qap, qap),
        "ackley": (j_ackley, ackley), "diagram": (j_diagram, diagram)}
PORT_FIELDS = [f.name for f in dataclasses.fields(SolverConfig)]


class _Stop(Exception):
    pass


def _record(monkeypatch, package):
    """Replace ``package``'s solvers and ``make_qap_problem`` by recorders;
    returns the list they append to."""
    calls = []

    def solver(kind):
        def fake(*args, **kwargs):
            calls.append((kind, args, kwargs))
            raise _Stop

        return fake

    ils = importlib.import_module(f"{package}.core.ils")
    pop = importlib.import_module(f"{package}.parallel.population")
    pmc = importlib.import_module(f"{package}.models.nqueens_parallel")
    qap_mod = importlib.import_module(f"{package}.models.qap")
    monkeypatch.setattr(ils, "Solver", solver("solver"))
    monkeypatch.setattr(pop, "PopulationSolver", solver("population"))
    monkeypatch.setattr(pmc, "ParallelMinConflictsSolver", solver("pmc"))
    make_qap, random_spec = qap_mod.make_qap_problem, qap_mod.QAPSpec.random

    def recorded_spec(n, seed=0):
        # The CLI picks its QAP mode from --size; above 512 a small stand-in
        # instance keeps the test from building n² tuples in both packages.
        calls.append(("qap_spec", (n, seed), {}))
        return random_spec(n if n <= 512 else 64, seed=seed)

    def recorded_qap(spec, **kw):
        calls.append(("qap_problem", (len(spec.flow),), kw))
        return make_qap(spec, **kw)

    monkeypatch.setattr(qap_mod.QAPSpec, "random", staticmethod(recorded_spec))
    monkeypatch.setattr(qap_mod, "make_qap_problem", recorded_qap)
    return calls


def _summary(calls):
    """What each recorded call built, without the device arguments."""
    out = []
    for kind, args, kwargs in calls:
        kwargs = {k: v for k, v in kwargs.items() if k not in ("device", "use_pallas")}
        if kind in ("solver", "population"):
            problem, config = args[:2]
            out.append((kind, problem.name, problem.width, {f: getattr(config, f) for f in PORT_FIELDS}, kwargs))
        else:
            out.append((kind, args, kwargs))
    return out


def _run(main, argv):
    with pytest.raises(_Stop):
        main(argv)


ARGVS = [
    ("nqueens", []), ("nqueens", ["--population", "4"]), ("nqueens", ["--board-size", "1000", "--population", "256"]),
    ("nqueens", ["--algo", "pmc"]), ("nqueens", ["--algo", "pmc", "--board-size", "4096", "--population", "2"]),
    ("nqueens", ["--algo", "pmc", "--board-size", "64", "--pmc-sample-cols", "8"]),
    ("scheduling", []), ("scheduling", ["--population", "4"]), ("scheduling", ["--window-size", "50"]),
    ("scheduling", ["--select-topk", "64"]), ("scheduling", ["--proposer", "systematic", "--days", "14"]),
    ("scheduling", ["--proposer", "rescore", "--rounds", "7", "--seed", "x"]),
    ("qap", []), ("qap", ["--population", "4"]),
    *[("qap", ["--size", str(n), *extra]) for n in (64, 512, 4096) for extra in ([], ["--no-incremental"])],
    ("qap", ["--size", "512", "--incremental", "--compact"]),
    ("ackley", []), ("ackley", ["--population", "4", "--dims", "3"]),
    ("diagram", []), ("diagram", ["--population", "4"]), ("diagram", ["--chain", "--boxes", "5"]),
]


@pytest.mark.parametrize("cli, argv", ARGVS, ids=[f"{c}:{' '.join(a) or 'defaults'}" for c, a in ARGVS])
def test_same_argv_builds_the_same_solver(cli, argv, monkeypatch, capsys):
    jax_cli, port_cli = CLIS[cli]
    j_calls = _record(monkeypatch, "constraint_solver_tpu")
    t_calls = _record(monkeypatch, "constraint_solver_tpu_torch")
    _run(jax_cli.main, argv)
    _run(port_cli.main, argv)
    assert t_calls and _summary(t_calls) == _summary(j_calls)
    devices = [kw.get("device") for kind, _, kw in t_calls if not kind.startswith("qap")]
    assert devices == ["cuda"]
    t_calls.clear()
    _run(port_cli.main, [*argv, "--device", "cpu"])
    assert [kw.get("device") for kind, _, kw in t_calls if not kind.startswith("qap")] == ["cpu"]
    assert capsys.readouterr().out.count("example") == 3  # the banner, before the solver


def test_qap_modes_by_size(monkeypatch):
    """ROADMAP C3 (a), kept: compact is on for every size >= 512 without
    incremental, 4096 with --no-incremental included."""
    calls = _record(monkeypatch, "constraint_solver_tpu_torch")
    for n, extra in ((64, []), (512, []), (4096, []), (4096, ["--no-incremental"])):
        _run(qap.main, ["--size", str(n), *extra])
    sizes = [args[0] for kind, args, _ in calls if kind == "qap_spec"]
    modes = [(kw["compact"], kw["incremental"]) for kind, _, kw in calls if kind == "qap_problem"]
    assert sizes == [64, 512, 4096, 4096]
    assert modes == [(False, False), (True, False), (False, True), (True, False)]
    assert "2.1 GB" in qap.__doc__


def test_nqueens_cli_solves(capsys):
    score = nqueens.main(["--seed", "42", "--board-size", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert score == 0
    assert "result.score: 0" in out
    assert out.count("Q") == 8


def test_nqueens_pmc_cli_solves(capsys):
    assert nqueens.main(["--algo", "pmc", "--board-size", "12", "--population", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "result.score: 0" in out and out.count("Q") == 12 and "'steps'" in out


def test_scheduling_cli_runs(capsys):
    # Seven employees: with four, H4 (3 shifts per 14 days) is infeasible and
    # every descent runs its 1,000 iterations, minutes on the CPU.
    hard = scheduling.main(["--device", "cpu", "--rounds", "6", "--days", "14", "--employees", "7", "--quiet"])
    out = capsys.readouterr().out
    assert "result.score:" in out
    assert hard >= 0


def test_format_board_matches_reference_layout():
    """4x4 grid shape per the reference Debug printer (nqueens lib.rs:26-60)."""
    board = format_board([1, 3, 0, 2])
    lines = board.split("\n")
    assert len(lines) == 9
    assert lines[0] == "-" * 17
    assert lines[1] == "|   |   | Q |   |"
    assert lines[3] == "| Q |   |   |   |"


def test_nqueens_cli_checkpoint_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "nq.ckpt")
    nqueens.main(["--device", "cpu", "--board-size", "10", "--rounds", "4",
                  "--checkpoint", ckpt, "--checkpoint-every", "2", "--quiet"])
    capsys.readouterr()
    assert os.path.exists(checkpoint_path(ckpt))
    nqueens.main(["--device", "cpu", "--board-size", "10", "--rounds", "8", "--checkpoint", ckpt, "--quiet"])
    assert "resumed from" in capsys.readouterr().out


def test_population_cli_checkpoint_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "sched.ckpt")
    scheduling.main(["--device", "cpu", "--employees", "5", "--days", "14", "--rounds", "4", "--population", "4",
                     "--checkpoint", ckpt, "--checkpoint-every", "2", "--quiet"])
    capsys.readouterr()
    assert checkpoint_exists(ckpt)
    scheduling.main(["--device", "cpu", "--employees", "5", "--days", "14", "--rounds", "8", "--population", "4",
                     "--checkpoint", ckpt, "--quiet"])
    assert "resumed from" in capsys.readouterr().out


def test_ackley_cli_converges(capsys):
    rc = ackley.main(["--device", "cpu", "--dims", "2", "--rounds", "200"])
    out = capsys.readouterr().out
    assert rc == 0 and "result.value" in out


def test_qap_cli_checks_its_oracle(capsys):
    assert qap.main(["--device", "cpu", "--size", "16", "--rounds", "5"]) == 0
    out = capsys.readouterr().out
    perm = eval(out.split("result.permutation:", 1)[1].splitlines()[0])  # noqa: S307 — a printed list
    assert sorted(perm) == list(range(16)) and "result.cost:" in out


def test_diagram_cli_writes_routed_svg(tmp_path, capsys):
    path = tmp_path / "layout.svg"
    rc = diagram.main(["--device", "cpu", "--boxes", "6", "--edges", "5", "--rounds", "20", "--svg", str(path)])
    out = capsys.readouterr().out
    svg = path.read_text()
    assert rc == 0 and svg.startswith("<svg") and svg.count("<polyline") == 5
    assert f"routed SVG: {len(svg)} bytes" in out


@pytest.mark.parametrize(
    "cli, argv",
    [("nqueens", ["--board-size", "8"]), ("scheduling", ["--days", "7", "--employees", "3", "--rounds", "1"]),
     ("qap", ["--size", "8", "--rounds", "1"]), ("ackley", ["--dims", "2", "--rounds", "1"]),
     ("diagram", ["--boxes", "3", "--rounds", "1"])],
    ids=["nqueens", "scheduling", "qap", "ackley", "diagram"],
)
def test_default_device_is_the_card(cli, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError):
        CLIS[cli][1].main(argv)
