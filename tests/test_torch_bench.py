"""The port's benchmark (``bench_torch/run.py`` and ``BENCHMARK.json``) on the CPU.

The benchmark's data (four cells on one chip each, every metric with a unit, a
direction, a bound and exactly the cells that report it); a ``--device cpu``
rehearsal of every cell at tiny sizes that prints every metric, the device-only
ones as "not measured"; a corrupted best board, score or cost that fails the
run; the exit without a card; the other configuration kinds at tiny sizes; the
memory fields of a record; the bounds that ``bench_torch/bounds.py`` derives
from whole runs; and the runner's own checks (the date-based rescore against
the JAX package's scheduling score, the attacking-pair count against a
pair-by-pair count)."""

import datetime
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_torch import run as bench
from constraint_solver_tpu.models import scheduling as js
from constraint_solver_tpu_torch.parallel.population import PopulationSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("nqueens1000_p256", "sched365x20_dense_p64", "nqueens16384_p16", "qap4096_inc_p4")
HEADLINE, SCHED, BIG, QAP = CELLS
# nqueens-16 with 4 lanes (both N-Queens cells); scheduling 31 d x 7 e with 4
# lanes for 2 rounds of at most 10 descent iterations (the dense block costs ~20
# ms an iteration on the CPU); qap-8 with 2 lanes for 2 rounds of at most 10.
TINY = [
    f"{HEADLINE}.config.n=16", f"{HEADLINE}.config.population=4", f"{HEADLINE}.config.sample_cols=2",
    f"{SCHED}.config.instance.days=31", f"{SCHED}.config.instance.employees=7",
    f"{SCHED}.config.population=4",
    f"{SCHED}.config.solver_config.local_search_max_iterations=10", f"{SCHED}.traffic.warmup_rounds=1",
    f"{SCHED}.traffic.max_rounds=2",
    f"{BIG}.config.n=16", f"{BIG}.config.population=4", f"{BIG}.config.sample_cols=2",
    f"{QAP}.config.n=8", f"{QAP}.config.population=2", f"{QAP}.traffic.max_rounds=2",
    f"{QAP}.traffic.warmup_rounds=1", f"{QAP}.config.solver_config.local_search_max_iterations=10",
]


def _bench_json():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _argv(sets, *extra):
    return ["--device", "cpu", *extra, *(a for s in sets for a in ("--set", s))]


def test_benchmark_names_two_one_chip_cells_with_their_configurations():
    data = _bench_json()
    assert data["path"] == "bench_torch"
    assert [w["name"] for w in data["workloads"]] == list(CELLS)
    for w in data["workloads"]:
        assert w["chips"] == 1
        with open(os.path.join(REPO, w["config"])) as f:
            config = json.load(f)
        assert config["solver"] in bench.KINDS
        assert 0 < len(config["source"]) <= 200
        assert config["reduced"] == []
        assert w["traffic"]["repeats"] >= 3
    cells = bench.load_cells(data)
    assert cells[HEADLINE]["traffic"]["repeats"] == 15 and cells[SCHED]["traffic"]["repeats"] == 3
    assert cells[HEADLINE]["config"]["n"] == 1000 and cells[HEADLINE]["config"]["population"] == 256
    assert cells[HEADLINE]["traffic"]["chunk"] == 2 and cells[HEADLINE]["traffic"]["max_rounds"] is None
    assert cells[SCHED]["config"]["instance"]["days"] == 365 and cells[SCHED]["config"]["population"] == 64
    assert cells[SCHED]["traffic"]["max_rounds"] == 40 and cells[SCHED]["traffic"]["chunk"] == 4
    big, qap = cells[BIG], cells[QAP]
    assert (big["config"]["n"], big["config"]["population"], big["config"]["sample_cols"]) == (16384, 16, 64)
    assert big["config"]["seed_suffix"] == "-big" and big["config"]["exchange_every"] == 2
    assert big["config"]["solver_config"] == cells[HEADLINE]["config"]["solver_config"]
    assert big["traffic"] == {"warmup_rounds": 2, "repeats": 3, "chunk": 2, "max_rounds": 300, "wall_cap_s": 300}
    assert (qap["config"]["n"], qap["config"]["population"], qap["config"]["mode"]) == (4096, 4, "incremental")
    assert qap["config"]["instance_seed"] == 0 and qap["config"]["seed_suffix"] == ""
    assert qap["config"]["exchange_every"] == 10
    assert qap["traffic"] == {"warmup_rounds": 2, "repeats": 5, "chunk": 2, "max_rounds": 6, "wall_cap_s": 300}


def _reports(kind, metric):
    """Whether a cell of configuration kind ``kind`` reports ``metric``: time to
    zero where the run ends at zero conflicts, B1's metrics where its path runs
    B1, the rest everywhere."""
    if metric == "time_to_zero_s":
        return kind.target_zero
    if metric.startswith("kernel_"):
        return kind.kernel
    return True


@pytest.mark.parametrize("name", sorted(_bench_json()["metrics"]))
def test_metric_names_exactly_the_cells_whose_kind_reports_it(name):
    data = _bench_json()
    cells = bench.load_cells(data)
    want = [c for c in CELLS if _reports(bench.KINDS[cells[c]["config"]["solver"]], name)]
    assert data["metrics"][name]["workloads"] == want


@pytest.mark.parametrize("name", sorted(_bench_json()["metrics"]))
def test_metric_has_unit_direction_bound_and_cells(name):
    spec = _bench_json()["metrics"][name]
    assert spec["unit"]
    assert spec["direction"] in ("higher", "lower")
    assert spec["bound"] >= 0.1
    assert spec["workloads"] and set(spec["workloads"]) <= set(CELLS)
    assert spec["kind"] in ("end_to_end", "per_layer")
    assert isinstance(spec["device_only"], bool)


def test_cpu_rehearsal_prints_every_metric():
    proc = subprocess.run(
        [sys.executable, "bench_torch/run.py", *_argv(TINY)], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    records = {r["workload"]: r for r in map(json.loads, lines[:-1])}
    assert summary["ok"] is True
    assert summary["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    for name, spec in _bench_json()["metrics"].items():
        for cell in spec["workloads"]:
            got = records[cell]["metrics"][name]
            assert got["unit"] == spec["unit"]
            assert summary["workloads"][cell][name] == got["value"]
            if spec["device_only"]:
                assert got["value"] == "not measured"
            else:
                assert isinstance(got["value"], float) and got["value"] > 0
    repeats = {w["name"]: w["traffic"]["repeats"] for w in _bench_json()["workloads"]}
    for cell in CELLS:
        rec = records[cell]
        assert rec["correct"] and rec["failures"] == []
        assert rec["seed"] == ("bench-big" if cell == BIG else "bench")
        assert len(rec["repeats"]) == repeats[cell]
        assert rec["breakdown"]["top_device_ops"] == "not measured"
        assert rec["breakdown"]["idle_gaps"] == "not measured"
    assert records[HEADLINE]["metrics"]["moves_per_sec"]["samples"] == repeats[HEADLINE]
    assert all(r["best"] == [0.0, 0.0] for cell in (HEADLINE, BIG) for r in records[cell]["repeats"])
    assert all(r["rounds"] == 2 for cell in (SCHED, QAP) for r in records[cell]["repeats"])


def _corrupt_board(monkeypatch):
    real = PopulationSolver.get_best_solution

    def corrupted(self):
        score, best = real(self)
        rows = best.rows.copy()
        rows[0] = rows[1]  # two queens on one row: attacking, and not a permutation
        return score, best._replace(rows=rows)

    monkeypatch.setattr(PopulationSolver, "get_best_solution", corrupted)


def _corrupt_score(monkeypatch):
    real = PopulationSolver.get_best_solution

    def corrupted(self):
        (hard, soft), best = real(self)
        return (hard, soft + 1.0), best

    monkeypatch.setattr(PopulationSolver, "get_best_solution", corrupted)


def _corrupt_cost(monkeypatch):
    real = PopulationSolver.get_best_solution

    def corrupted(self):
        (cost, soft), best = real(self)
        return (2.0 * cost + 1.0, soft), best  # far beyond the check's float32 tolerance, COST_RTOL

    monkeypatch.setattr(PopulationSolver, "get_best_solution", corrupted)


@pytest.mark.parametrize("cell,corrupt,message", [
    (HEADLINE, _corrupt_board, "attacking pairs by a numpy count"),
    (SCHED, _corrupt_score, "date-based rescore"),
    (BIG, _corrupt_board, "attacking pairs by a numpy count"),
    (QAP, _corrupt_cost, "int64 host cost"),
])
def test_corrupted_best_fails_the_run(monkeypatch, capsys, cell, corrupt, message):
    corrupt(monkeypatch)
    sets = [s for s in TINY if s.startswith(cell)] + [f"{cell}.traffic.repeats=1"]
    assert bench.main(_argv(sets, "--cells", cell)) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    record, summary = json.loads(lines[-2]), json.loads(lines[-1])
    assert record["correct"] is False and summary["ok"] is False
    assert summary["workloads"][cell]["correct"] is False
    assert any(message in f for f in record["failures"]), record["failures"]


def test_without_a_card_the_runner_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main(["--cells", HEADLINE]) == 2
    assert capsys.readouterr().out == ""  # no result printed


@pytest.mark.parametrize("item", [
    "nocell.config.n=3", f"{HEADLINE}.config.nokey=3", f"{HEADLINE}.params.n=3", f"{HEADLINE}.config.n",
    f"{SCHED}.config.instance.nokey.days=3",
])
def test_overrides_name_keys_the_cell_has(item):
    cells = bench.load_cells(_bench_json())
    with pytest.raises(SystemExit):
        bench.apply_overrides(cells, [item])


# Tiny configurations of the kinds the left-out cells need, and the other proposers.
KIND_CASES = {
    "qap_dense": {"solver": "qap_population", "n": 8, "instance_seed": 0, "mode": "dense"},
    "qap_compact": {"solver": "qap_population", "n": 8, "instance_seed": 0, "mode": "compact"},
    "qap_incremental": {"solver": "qap_population", "n": 8, "instance_seed": 0, "mode": "incremental"},
    "sched_random": {"solver": "scheduling_population", "proposer": "random"},
    "sched_systematic": {"solver": "scheduling_population", "proposer": "systematic"},
    "pmc": {"solver": "pmc", "n": 16, "population": 2, "max_steps": 2000, "sample_cols": None},
}


def _kind_cell(case):
    config = {"seed_suffix": "-big", "population": 2, "exchange_every": 2,
              "solver_config": {"local_search_max_iterations": 10, "best_solutions_capacity": 4,
                                "all_solutions_capacity": 32},
              **KIND_CASES[case]}
    if config["solver"] == "scheduling_population":
        config.update(instance={"start": "2024-01-01", "days": 14, "employees": 4, "holidays_per_employee": 2,
                                "holiday_employee_stride": 17, "holiday_day_stride": 11},
                      window_size=16, n_rand_swaps=8)
    traffic = {"warmup_rounds": 1, "repeats": 2, "chunk": 1, "max_rounds": 2, "wall_cap_s": 60,
               "trace_steps": 4}
    return {"name": case, "config_path": f"{case}.json", "config": config, "traffic": traffic}


def _run_cell(cell, metrics):
    """A cell's repeats, then its traced round and metrics, on the CPU."""
    device = torch.device("cpu")
    kind, record = bench.time_cell(cell, device, "bench", bench.describe_device(device))
    return bench.trace_cell(kind, record, device, metrics)


@pytest.mark.parametrize("case", list(KIND_CASES))
def test_other_kinds_run_and_check_on_cpu(case):
    names = ("moves_per_sec", "ms_per_iteration", "host_reads_per_iteration", "launches_per_iteration")
    metrics = {m: {"unit": "u", "workloads": [case]} for m in names}
    if case == "pmc":
        metrics["time_to_zero_s"] = {"unit": "s", "workloads": [case]}
    rec = _run_cell(_kind_cell(case), metrics)
    assert rec["correct"], rec["failures"]
    assert rec["seed"] == "bench-big"
    assert len(rec["repeats"]) == 2 and rec["breakdown"]["iterations"] > 0
    assert rec["metrics"]["moves_per_sec"]["value"] > 0
    assert rec["metrics"]["launches_per_iteration"]["value"] == "not measured"
    if case == "pmc":
        assert rec["metrics"]["time_to_zero_s"]["samples"] == 2


def test_record_carries_peak_and_reserved_memory():
    rec = _run_cell(_kind_cell("qap_incremental"), {})
    assert rec["peak_memory_bytes"] == rec["reserved_memory_bytes"] == "not measured"


def test_qap_record_carries_cost_gaps_and_lane_gains():
    rec = _run_cell(_kind_cell("qap_incremental"), {})
    for rep in rec["repeats"]:
        assert rep["cost_gap"] == {"best": 0.0, "lanes_max": 0.0}  # float32 is exact below 2^24
        assert len(rep["lane_gain"]) == 2 and min(rep["lane_gain"]) >= bench.QAPPopulation.MIN_GAIN
        assert rep["host"]["cpu_s"] > 0 and set(rep["host"]) == {"cpu_s", "voluntary_switches",
                                                                  "involuntary_switches"}
    assert rec["host_cpus"] == sorted(os.sched_getaffinity(0))


def _plant(monkeypatch, plant):
    """Make the runner's QAP problem carry a planted fault."""
    real = bench.make_qap_problem

    def make(spec, **kw):
        prob = real(spec, **kw)
        if plant == "state_unchanged":  # the move's score is carried, its state is not
            return prob._replace(in_place=prob.in_place._replace(move=lambda st, moves, idx, mask: None))
        if plant in ("g_drift", "h_drift"):
            # One entry of every lane's G or H one off in the state the solver
            # carries out of a descent, which is rebuilt from the best's p.
            def rebuild(p):
                st = prob.in_place.rebuild(p)
                getattr(st, plant[0])[:, 0, 1] += 1.0
                return st

            return prob._replace(in_place=prob.in_place._replace(rebuild=rebuild))
        if plant == "move_g_drift":
            # G's entry (0, 1) one more in every lane the in-place move writes,
            # after each move.  The check does not read the descent's own G:
            # the drift reaches it only through the costs of the moves taken.
            def move(st, moves, idx, mask):
                prob.in_place.move(st, moves, idx, mask)
                st.g[:, 0, 1] += mask.to(st.g.dtype)

            return prob._replace(in_place=prob.in_place._replace(move=move))

        def neighborhood(*args):  # no valid move for every lane, or for the upper half
            nb = prob.neighborhood(*args)
            lanes = nb.valid.shape[0]
            off = torch.arange(lanes) >= (0 if plant == "never_accepts" else lanes // 2)
            return nb._replace(valid=nb.valid & ~off[:, None], n_valid=torch.where(off, 0, nb.n_valid))

        return prob._replace(neighborhood=neighborhood)

    monkeypatch.setattr(bench, "make_qap_problem", make)


@pytest.mark.parametrize("plant,n,message", [
    ("state_unchanged", 8, "carried cost"),
    ("g_drift", 8, "carried G differs"),
    ("h_drift", 8, "carried H differs"),
    ("move_g_drift", 8, "carried cost"),
    ("never_accepts", 256, "lanes [0, 1]: best cost"),
    ("half_lanes", 256, "lanes [1]: best cost"),
])
def test_qap_check_fails_a_planted_fault(monkeypatch, plant, n, message):
    _plant(monkeypatch, plant)
    cell = _kind_cell("qap_incremental")
    cell["config"].update(n=n, exchange_every=10)  # no exchange: each lane's best is its own descent's
    rec = _run_cell(cell, {})
    assert not rec["correct"]
    assert any(message in f for f in rec["failures"]), rec["failures"]


def test_qap_plant_script_reads_the_check(capsys):
    """``scripts/qap_plant.py`` on the CPU at n = 8: the control passes the
    runner's check, a G drift planted in the rebuilt best fails it on G, and
    the in-place move's G drift fails it through the cost."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts", "qap_plant.py")
    spec = importlib.util.spec_from_file_location("qap_plant", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--n", "8", "--plants", "none", "rebuild_g_drift", "move_g_drift"]) == 0
    reading = json.loads(capsys.readouterr().out.splitlines()[-1])
    none, rebuild, move = reading["plants"]
    assert none["correct"] and none["cost_gap"] == {"best": 0.0, "lanes_max": 0.0} and none["iterations"] == 300
    assert not rebuild["correct"] and "carried G differs" in rebuild["failures"][0]
    assert not move["correct"] and all("carried cost" in f for f in move["failures"])


def test_unknown_metric_or_solver_raises():
    cell = _kind_cell("qap_dense")
    with pytest.raises(ValueError, match="does not compute"):
        _run_cell(cell, {"rounds_per_day": {"unit": "u", "workloads": ["qap_dense"]}})
    cell["config"]["solver"] = "ackley_population"
    with pytest.raises(ValueError, match="unknown solver"):
        _run_cell(cell, {})


@pytest.mark.parametrize("days,emps", [(31, 7), (60, 5), (365, 20)])
def test_date_based_rescore_equals_the_jax_score(days, emps):
    inst = {"start": "2024-01-01", "days": days, "employees": emps, "holidays_per_employee": 10,
            "holiday_employee_stride": 17, "holiday_day_stride": 11}
    _, d0, hols = bench.bench_instance(inst)
    jspec = js.ScheduleSpec.from_dates(d0, d0 + datetime.timedelta(days=days - 1), emps, hols)
    rng = np.random.default_rng(days)
    assign = rng.integers(0, emps, (4, days))
    assign[0] = 0  # one employee every day: every constraint fires
    want = np.asarray(jax.jit(jax.vmap(js.make_scheduling_problem(jspec).score))(jnp.asarray(assign)))
    got = [bench.oracle_schedule_score(d0, a.tolist(), hols) for a in assign]
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


def test_bench_instance_is_the_jax_bench_family():
    spec, d0, hols = bench.bench_instance({"start": "2024-01-01", "days": 365, "employees": 20,
                                           "holidays_per_employee": 10, "holiday_employee_stride": 17,
                                           "holiday_day_stride": 11})
    assert d0 == datetime.date(2024, 1, 1) and spec.num_days == 365 and spec.num_employees == 20
    assert hols[3] == [d0 + datetime.timedelta(days=(17 * 3 + 11 * k) % 365) for k in range(10)]
    assert spec.holiday_array().sum() == 200


@pytest.mark.parametrize("n", [1, 5, 8, 17])
def test_attacking_pairs_equal_a_pair_by_pair_count(n):
    rng = np.random.default_rng(n)
    for rows in (rng.integers(0, n, n), rng.permutation(n)):
        want = sum(rows[i] == rows[j] or abs(int(rows[i]) - int(rows[j])) == j - i
                   for i in range(n) for j in range(i + 1, n))
        assert bench.attacking_pairs(rows) == want


def test_kernel_bound_is_bytes_over_the_hbm_rate():
    from constraint_solver_tpu_torch.ops.nqueens_kernel import kernel_work

    ops, nbytes = kernel_work(256, 50, 1000)
    assert bench.kernel_bound_ms(256, 50, 1000) == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert nbytes / 3.35e12 > ops / 67e12  # bytes bound B1 at the headline's shape


def _summary(values, ok=True):
    return {"ok": ok, "workloads": {cell: dict(metrics) for cell, metrics in values.items()}}


def test_bounds_follow_the_rule_from_whole_runs(tmp_path, capsys):
    from bench_torch import bounds

    runs = [
        _summary({HEADLINE: {"moves_per_sec": 100.0, "time_to_zero_s": 1.0}, SCHED: {"moves_per_sec": 50.0}}),
        _summary({HEADLINE: {"moves_per_sec": 104.0, "time_to_zero_s": 1.3}, SCHED: {"moves_per_sec": 51.0}}),
        _summary({HEADLINE: {"moves_per_sec": 101.0, "time_to_zero_s": 1.1}}),  # a run of one cell only
    ]
    paths = []
    for i, summary in enumerate(runs):
        path = tmp_path / f"run{i}.json"
        path.write_text('{"workload": "a record"}\n' + json.dumps(summary) + "\n")
        paths.append(str(path))
    assert bounds.main(paths) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    current = {name: spec["bound"] for name, spec in _bench_json()["metrics"].items()}
    # moves/s: 0.04 over the headline's runs, wider than the roster's 0.02; twice that is under 0.10.
    assert out["moves_per_sec"]["widest_spread"] == pytest.approx(0.04)
    assert out["moves_per_sec"] == {**out["moves_per_sec"], "bound": 0.10, "current": current["moves_per_sec"]}
    # time to zero: 0.30, so twice it, 0.60, whatever the file holds now (shown beside it).
    assert out["time_to_zero_s"]["widest_spread"] == pytest.approx(0.30)
    assert out["time_to_zero_s"]["bound"] == 0.60
    assert out["time_to_zero_s"]["current"] == current["time_to_zero_s"]
    # No two numbers: the floor.
    assert out["kernel_ms_per_launch"] == {"widest_spread": None, "bound": 0.10, "current": 0.10}
    assert bounds.bound(0.0512) == 0.11 and bounds.bound(0.03) == 0.10 and bounds.bound(0.9) == 1.8
    failed = tmp_path / "failed.json"
    failed.write_text(json.dumps(_summary({}, ok=False)))
    assert bounds.main([paths[0], str(failed)]) == 1
