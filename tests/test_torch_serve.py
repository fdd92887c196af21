"""The port's HTTP solver service (``constraint_solver_tpu_torch.serve.server``):
the mirror of ``tests/test_serve.py``'s 16 tests, against
``python -m constraint_solver_tpu_torch.serve.server --port 0 --device cpu`` run
as a subprocess (its production shape), and the validation messages of its
``SolverService`` against the JAX service's, payload for payload."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from constraint_solver_tpu.serve.server import SolverService as JaxService
from constraint_solver_tpu_torch.serve.server import SolverService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEEK = {"startDate": "2022-05-09", "endDate": "2022-05-15"}


@pytest.fixture(scope="module")
def server_url():
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "constraint_solver_tpu_torch.serve.server", "--port", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    url = None
    for line in proc.stdout:
        if line.startswith("serving on "):
            url = line.split("serving on ", 1)[1].strip()
            break
    assert url, "server did not report its address"
    yield url
    proc.terminate()
    proc.wait(timeout=30)


def _req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _solve(server_url, payload, max_ticks, until_hard_zero=False):
    """Create a solver, tick it until finished (at most ``max_ticks``) or, with
    ``until_hard_zero``, until its best has hard score 0 (the best never
    worsens, so later ticks would keep it); delete it; returns the last
    round's payload."""
    status, res = _req(server_url + "/api/solvers", "POST", payload)
    assert status == 200, res
    sid = res["solverId"]
    for _ in range(max_ticks):
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        if r["isFinished"] or (until_hard_zero and r["result"]["score"]["hard_score"] == 0):
            break
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")
    return r


def test_full_worker_protocol(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        "startDate": "2022-05-09", "endDate": "2022-05-22",
        "employees": [{"id": 0}, {"id": 1}, {"id": 2}, {"id": 3}],
        "employeeHolidays": [[], ["2022-05-10"], [], []],
        "iterated_local_search_max_iterations": 5, "local_search_max_iterations": 100,
    })
    assert status == 200
    sid = res["solverId"]
    ticks = 0
    while True:
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        assert set(r) == {"isFinished", "iterationInfo", "result"}
        ticks += 1
        if r["isFinished"]:
            break
        assert ticks < 20
    assert r["iterationInfo"]["current"] == 5
    assert r["result"]["score"]["hard_score"] >= 0
    day0, emp0 = r["result"]["days_to_employees"][0]
    assert day0 == "Mon 2022-05-09" and "id" in emp0
    assert len(r["result"]["days_to_employees"]) == 14
    status, info = _req(f"{server_url}/api/solvers/{sid}/info")
    assert (status, info["current"]) == (200, 5)
    status, best = _req(f"{server_url}/api/solvers/{sid}/best")
    assert status == 200 and "score" in best
    status, _ = _req(f"{server_url}/api/solvers/{sid}", "DELETE")
    assert status == 200
    status, _ = _req(f"{server_url}/api/solvers/{sid}/info")
    assert status == 404


# Every invalid payload of ``tests/test_serve.py``, with a word its error must hold.
INVALID = {
    "endDate-before-start": ({"startDate": "2022-05-09", "endDate": "2022-05-01", "employees": [{"id": 0}],
                              "employeeHolidays": [[]]}, "endDate"),
    "no-employees": ({"startDate": "2022-05-09", "endDate": "2022-05-10", "employees": [],
                      "employeeHolidays": []}, "employee"),
    "missing-fields": ({"employees": []}, "startDate"),
    "unknown-problem": ({"problem": "sudoku"}, "sudoku"),
    "uncoercible-int": ({**WEEK, "employees": [{"id": 0}], "employeeHolidays": [[]],
                         "local_search_max_iterations": "many"}, "many"),
    "short-holidays": ({**WEEK, "employees": [{"id": 0}, {"id": 1}, {"id": 2}],
                        "employeeHolidays": [[], ["2022-05-10"]]}, "employeeHolidays"),
    **{f"population-{k}": ({**WEEK, "employees": [{"id": 0}, {"id": 1}], "employeeHolidays": [[], []], **bad},
                           "population")
       for k, bad in enumerate(({"population": 500}, {"population": 0}, {"population": "lots"},
                                {"population": 128, "proposer": "dense"}))},
    "select-temp-0": ({"startDate": "2022-05-09", "endDate": "2022-05-22",
                       "employees": [{"id": i} for i in range(5)], "employeeHolidays": [[]] * 5,
                       "proposer": "dense", "select_topk": 64, "select_temp": 0}, "select_temp"),
    "boardSize": ({"problem": "nqueens", "boardSize": 0}, "boardSize"),
    "boxes": ({"problem": "diagram", "boxes": 600}, "boxes"),
    "proposer": ({**WEEK, "employees": [{"id": 0}], "employeeHolidays": [[]], "proposer": "tabu"}, "proposer"),
}


@pytest.mark.parametrize("payload, word", list(INVALID.values()), ids=list(INVALID))
def test_invalid_payloads_return_400(server_url, payload, word):
    status, err = _req(server_url + "/api/solvers", "POST", payload)
    assert status == 400 and word in err["error"], err


@pytest.mark.parametrize("payload, word", list(INVALID.values()), ids=list(INVALID))
def test_validation_messages_equal_the_jax_service(payload, word):
    """Raised before any solver is built, so neither side compiles or runs."""
    with pytest.raises(ValueError) as jax_error:
        JaxService().create(payload)
    with pytest.raises(ValueError) as port_error:
        SolverService(device="cpu").create(payload)
    assert str(port_error.value) == str(jax_error.value)


def test_unknown_solver_is_404(server_url):
    status, _ = _req(server_url + "/api/solvers/nope/round", "POST")
    assert status == 404
    status, _ = _req(server_url + "/api/nowhere")
    assert status == 404


def test_index_page(server_url):
    with urllib.request.urlopen(server_url + "/") as resp:
        html = resp.read().decode()
    assert "Employee scheduling" in html and "Start solving" in html
    for part in ("addEmployee", "holidays", "employeeHolidays", 'class="rm"'):
        assert part in html
    assert "TPU" not in html


def test_best_before_first_round_is_valid_json(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        **WEEK, "employees": [{"id": 0}, {"id": 1}], "employeeHolidays": [[], []],
    })
    sid = res["solverId"]
    status, best = _req(f"{server_url}/api/solvers/{sid}/best")
    assert status == 200
    assert best["score"]["hard_score"] is None and best["days_to_employees"] == []
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_nqueens_solver_endpoint(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        "problem": "nqueens", "boardSize": 8, "seed": "42", "iterated_local_search_max_iterations": 30,
    })
    assert status == 200
    sid = res["solverId"]
    for _ in range(30):
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        if r["isFinished"]:
            break
    assert sorted(r["result"]["rows"]) == list(range(8))
    assert r["result"]["score"]["hard_score"] == 0.0
    status, err = _req(f"{server_url}/api/solvers/{sid}/svg")
    assert status == 400 and "diagram" in err["error"]
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_diagram_solver_endpoint_with_svg(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        "problem": "diagram", "boxes": 5, "edges": 4, "grid": 8, "iterated_local_search_max_iterations": 15,
    })
    assert status == 200
    sid = res["solverId"]
    for _ in range(15):
        status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
        assert status == 200
        if r["isFinished"]:
            break
    pos = r["result"]["positions"]
    assert len(pos) == 5 and all(len(p) == 2 for p in pos)
    with urllib.request.urlopen(f"{server_url}/api/solvers/{sid}/svg") as resp:
        assert resp.headers["Content-Type"] == "image/svg+xml"
        svg = resp.read().decode()
    assert svg.startswith("<svg") and svg.count("<polyline") == 4
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_numeric_seed_and_stringy_ints_coerced(server_url):
    status, res = _req(server_url + "/api/solvers", "POST", {
        **WEEK, "employees": [{"id": 0}, {"id": 1}], "employeeHolidays": [[], []],
        "seed": 42, "iterated_local_search_max_iterations": "3",
    })
    assert status == 200
    sid = res["solverId"]
    status, r = _req(f"{server_url}/api/solvers/{sid}/round", "POST")
    assert status == 200 and r["iterationInfo"]["total"] == 3
    _req(f"{server_url}/api/solvers/{sid}", "DELETE")


def test_ui_shaped_holiday_payload_drives_h1(server_url):
    """The only employee is on holiday every day: every day is an H1 violation."""
    days = ["2022-05-%02d" % d for d in range(9, 16)]
    r = _solve(server_url, {
        "startDate": days[0], "endDate": days[-1], "employees": [{"id": 5}], "employeeHolidays": [days],
        "iterated_local_search_max_iterations": 2, "local_search_max_iterations": 20,
    }, 1)
    assert r["result"]["score"]["hard_score"] >= 7.0
    assert r["result"]["days_to_employees"][0][1]["id"] == 5


@pytest.mark.parametrize(
    "payload, ticks",
    [
        # three employees, one holiday each on different days: H1 is avoidable
        ({**WEEK, "employees": [{"id": 0}, {"id": 1}, {"id": 2}],
          "employeeHolidays": [["2022-05-10"], ["2022-05-11"], []],
          "iterated_local_search_max_iterations": 30, "local_search_max_iterations": 200}, 30),
        # the quality configuration: population with the random proposer
        ({"startDate": "2022-05-09", "endDate": "2022-05-22", "employees": [{"id": i} for i in range(5)],
          "employeeHolidays": [[]] * 5, "proposer": "random", "population": 4,
          "iterated_local_search_max_iterations": 25, "local_search_max_iterations": 200}, 25),
        # the noisy dense selection
        ({"startDate": "2022-05-09", "endDate": "2022-05-22", "employees": [{"id": i} for i in range(5)],
          "employeeHolidays": [[]] * 5, "proposer": "dense", "select_topk": 64, "select_temp": 0.5,
          "iterated_local_search_max_iterations": 40, "local_search_max_iterations": 200}, 40),
    ],
    ids=["holidays-avoidable", "population-random", "noisy-dense"],
)
def test_feasible_requests_reach_hard_zero(server_url, payload, ticks):
    r = _solve(server_url, payload, ticks, until_hard_zero=True)
    assert r["result"]["score"]["hard_score"] == 0
    days = (payload["endDate"] > payload["startDate"]) and len(r["result"]["days_to_employees"])
    assert days in (7, 14)


def test_systematic_proposer_served(server_url):
    r = _solve(server_url, {**WEEK, "employees": [{"id": i} for i in range(3)], "employeeHolidays": [[]] * 3,
                            "proposer": "systematic", "iterated_local_search_max_iterations": 3}, 3)
    assert r["isFinished"] and r["result"]["score"]["hard_score"] is not None
