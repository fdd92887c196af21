"""Round-based solver service — the reference's L4/L5 serving stack
(port of ``constraint_solver_tpu/serve/server.py``).

The reference serves employee scheduling to a browser through a wasm bridge
with an opaque solver context and per-tick stepping (reference
web/employee-scheduling-wasm-bindgen/src/lib.rs:13-110), driven by a Web
Worker message loop (web/employee-scheduling/src/worker.ts:1-29) and a Vue
form UI (web/employee-scheduling/src/index.ts:1-97).  The capability being
preserved (SURVEY.md §3.3): **incremental, cancellable, progress-reporting
solving that never blocks the UI**.

A small HTTP service (stdlib only) holding live solver contexts; each round
executes on the service's device and returns the same payload shape the
worker posts back: ``{isFinished, iterationInfo, result}``.

API (mirroring the wasm exports):
- ``POST /api/solvers``                 -> create_solver    (lib.rs:19-53)
  (``payload["problem"]`` picks the domain: scheduling [default, the wasm
  payload shape], nqueens, or diagram — one service fronts every domain)
- ``POST /api/solvers/<id>/round``      -> execute_solver_round + info + best
- ``GET  /api/solvers/<id>/best``       -> get_best_solution (lib.rs:72-84)
- ``GET  /api/solvers/<id>/info``       -> get_iteration_info
- ``GET  /api/solvers/<id>/svg``        -> routed layout SVG (diagram only)
- ``DELETE /api/solvers/<id>``          -> cancel + free
- ``GET  /``                            -> single-file web UI

Divergences from the JAX service:

- ``SolverService(device="cuda")`` builds every solver on its device; there
  is no check for a card and no fallback.  ``main()`` takes ``--device
  {cuda,cpu}`` (default ``cuda``) instead of ``--platform {tpu,cpu}`` and
  prints the device's name from torch.
- No 64 MB thread stack: it worked around XLA compiles in handler threads,
  and nothing compiles here.  Handler threads share the device's default
  stream, so concurrent rounds are correct and serialised on the device; each
  context keeps its lock, as in the JAX service.
- The index page says "solver service" where the JAX page says "TPU solver".

Routes, payloads, defaults, validation messages and the population bounds
are the JAX service's: the bounds stay as the API's contract.
"""

from __future__ import annotations

import datetime
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_WEEKDAYS = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]

# Reference wasm-bridge hyperparameters (wasm lib.rs:30-37), plus the
# noisy-selection knobs (select_topk/select_temp — sample the
# applied dense-block move from the top-k instead of the argmin; the
# measured round-5 dense quality configuration is topk=64, temp=0.5).
_DEFAULTS = dict(
    seed="42",
    local_search_max_iterations=1_000,
    window_size=100,
    proposer="dense",
    best_solutions_capacity=64,
    all_solutions_capacity=512,
    all_solution_iteration_expiry=1_000,
    iterated_local_search_max_iterations=250,
    max_allow_no_improvement_for=20,
    select_topk=0,
    select_temp=1.0,
)
_FLOAT_PARAMS = ("select_temp",)


class SolverService:
    """Holds live solver contexts (the wasm ``SolverContext`` pattern)."""

    def __init__(self, device="cuda") -> None:
        self.device = device
        self._solvers: dict[str, dict] = {}
        self._lock = threading.Lock()

    def create(self, payload: dict) -> str:
        """Create a solver context.  ``payload["problem"]`` selects the
        domain — "scheduling" (default, the reference wasm payload shape),
        "nqueens", or "diagram" (extras: one service fronts every domain, not
        just the one the reference compiled to wasm)."""
        kind = payload.get("problem", "scheduling")
        makers = {
            "scheduling": self._create_scheduling,
            "nqueens": self._create_nqueens,
            "diagram": self._create_diagram,
        }
        if kind not in makers:
            raise ValueError(f"unknown problem {kind!r}")
        ctx = makers[kind](payload)
        ctx["kind"] = kind
        ctx["lock"] = threading.Lock()
        sid = uuid.uuid4().hex[:12]
        with self._lock:
            self._solvers[sid] = ctx
        return sid

    def _create_scheduling(self, payload: dict) -> dict:
        from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
        from constraint_solver_tpu_torch.models.scheduling import (
            ScheduleSpec,
            make_scheduling_problem,
        )

        for field in ("startDate", "endDate"):
            if field not in payload:
                raise ValueError(f"missing required field {field!r}")
        start = datetime.date.fromisoformat(payload["startDate"])
        end = datetime.date.fromisoformat(payload["endDate"])
        employees = [e["id"] for e in payload.get("employees", [])]
        holiday_lists = payload.get("employeeHolidays", [])
        if len(holiday_lists) != len(employees):
            raise ValueError(
                f"employeeHolidays has {len(holiday_lists)} entries for "
                f"{len(employees)} employees (zip would silently drop some)"
            )
        holidays = {
            emp["id"]: [datetime.date.fromisoformat(d) for d in days]
            for emp, days in zip(payload.get("employees", []), holiday_lists)
        }
        if not employees:
            raise ValueError("at least one employee required")
        if end < start:
            raise ValueError("endDate before startDate")
        # Coerce JSON payload values (a numeric seed or stringy iteration
        # count must not crash the handler thread).
        params = {**_DEFAULTS, **{
            k: payload[k] for k in _DEFAULTS if k in payload
        }}
        params["seed"] = str(params["seed"])
        for k in params:
            if k in _FLOAT_PARAMS:
                params[k] = float(params[k])
            elif k not in ("seed", "proposer"):
                params[k] = int(params[k])
        if params["proposer"] not in ("dense", "random", "rescore", "systematic"):
            raise ValueError(f"unknown proposer {params['proposer']!r}")
        if not 0 <= params["select_topk"] <= 4096:
            raise ValueError("select_topk out of range (0..4096)")
        if not 0.0 < params["select_temp"] <= 1e6:
            raise ValueError("select_temp out of range")
        spec = ScheduleSpec.from_dates(start, end, len(employees), {
            employees.index(e): days for e, days in holidays.items()
        })
        problem = make_scheduling_problem(
            spec, window_size=params["window_size"],
            proposer=params["proposer"],
        )
        config_kwargs = {
            k: v for k, v in params.items()
            if k not in ("window_size", "proposer")
        }
        # Beyond the wasm contract: "population" > 1 solves with P parallel
        # trajectories + elite exchange every 2 rounds (same round-based
        # API; execute_round steps a round-gated chunk, so the cadence is
        # live under per-tick stepping).  Pair with proposer="random" for
        # the measured quality-at-wall winner (BENCH_NOTES.md round 4).
        # The bounds are the JAX service's (set there by compile-size limits
        # of its TPU) and stay as the API's contract.
        try:
            population = int(payload.get("population", 1))
        except (TypeError, ValueError):
            raise ValueError("population must be an integer")
        if not 1 <= population <= 256:
            raise ValueError("population out of range (1..256)")
        if params["proposer"] == "dense" and population > 64:
            raise ValueError(
                "population > 64 with the dense proposer exceeds the "
                "compile-size budget; use proposer='random' or P <= 64"
            )
        if population > 1:
            from constraint_solver_tpu_torch.parallel.population import (
                PopulationSolver,
            )

            solver = PopulationSolver(
                problem, SolverConfig(**config_kwargs),
                population=population, exchange_every=2, device=self.device,
            )
        else:
            solver = Solver(problem, SolverConfig(**config_kwargs), device=self.device)
        return {"solver": solver, "start": start, "employees": employees}

    def _create_nqueens(self, payload: dict) -> dict:
        from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
        from constraint_solver_tpu_torch.models.nqueens import make_nqueens_problem

        n = int(payload.get("boardSize", 8))
        if not 1 <= n <= 10_000:
            raise ValueError("boardSize out of range")
        # Reference nqueens CLI hyperparameters (nqueens main.rs:129-135).
        config = SolverConfig(
            seed=str(payload.get("seed", "42")),
            local_search_max_iterations=10_000,
            best_solutions_capacity=32,
            all_solutions_capacity=512,
            all_solution_iteration_expiry=10_000,
            iterated_local_search_max_iterations=int(
                payload.get("iterated_local_search_max_iterations", 10_000)
            ),
            max_allow_no_improvement_for=5,
        )
        return {"solver": Solver(make_nqueens_problem(n), config, device=self.device)}

    def _create_diagram(self, payload: dict) -> dict:
        from constraint_solver_tpu_torch.core.ils import Solver, SolverConfig
        from constraint_solver_tpu_torch.models.diagram_layout import (
            DiagramLayoutSpec,
            make_diagram_layout_problem,
        )

        n_boxes = int(payload.get("boxes", 9))
        grid = int(payload.get("grid", 12))
        if not 1 <= n_boxes <= 512 or not 1 <= grid <= 128:
            raise ValueError("boxes/grid out of range")
        if payload.get("chain"):
            spec = DiagramLayoutSpec.chain(n_boxes, grid)
        else:
            spec = DiagramLayoutSpec.random(
                n_boxes,
                int(payload.get("edges", max(1, n_boxes - 1))),
                grid,
                seed=int(payload.get("instanceSeed", 0)),
                max_size=int(payload.get("maxSize", 3)),
            )
        config = SolverConfig(
            seed=str(payload.get("seed", "42")),
            local_search_max_iterations=200,
            best_solutions_capacity=32,
            all_solutions_capacity=512,
            all_solution_iteration_expiry=10_000,
            iterated_local_search_max_iterations=int(
                payload.get("iterated_local_search_max_iterations", 200)
            ),
            max_allow_no_improvement_for=5,
        )
        problem = make_diagram_layout_problem(spec)
        return {"solver": Solver(problem, config, device=self.device), "spec": spec}

    def _ctx(self, sid: str) -> dict:
        with self._lock:
            if sid not in self._solvers:
                raise KeyError(sid)
            return self._solvers[sid]

    def round(self, sid: str) -> dict:
        ctx = self._ctx(sid)
        with ctx["lock"]:
            solver = ctx["solver"]
            solver.execute_round()
            return {
                "isFinished": solver.is_finished(),
                "iterationInfo": solver.get_iteration_info(),
                "result": self._best_payload(ctx),
            }

    def best(self, sid: str) -> dict:
        ctx = self._ctx(sid)
        with ctx["lock"]:
            return self._best_payload(ctx)

    def info(self, sid: str) -> dict:
        ctx = self._ctx(sid)
        with ctx["lock"]:
            return ctx["solver"].get_iteration_info()

    def delete(self, sid: str) -> None:
        with self._lock:
            ctx = self._solvers.pop(sid, None)
        if ctx:
            ctx["solver"].cancel()

    def svg(self, sid: str) -> str:
        """Routed SVG of the best diagram layout (diagram solvers only)."""
        ctx = self._ctx(sid)
        if ctx.get("kind") != "diagram":
            raise ValueError("svg is only available for diagram solvers")
        with ctx["lock"]:
            import math

            from constraint_solver_tpu_torch.diagram.route import render_routed
            from constraint_solver_tpu_torch.models.diagram_layout import (
                layout_to_boxes,
            )

            (hard, _), pos = ctx["solver"].get_best_solution()
            if not math.isfinite(hard):
                raise ValueError("no solution yet: run at least one round")
            spec = ctx["spec"]
            return render_routed(layout_to_boxes(spec, pos), list(spec.edges))

    def _best_payload(self, ctx: dict) -> dict:
        """Per-domain best-solution payload.  Scheduling keeps the wasm
        get_best_solution shape: score + '%a %Y-%m-%d' day keys
        (wasm lib.rs:71-84)."""
        import math

        (hard, soft), assign = ctx["solver"].get_best_solution()
        if not (math.isfinite(hard) and math.isfinite(soft)):
            # No round has run yet: the elite archive is empty (the
            # reference would panic on get_best_solution here).  Report a
            # null score and no assignment instead of invalid-JSON Infinity.
            empty = {"score": {"hard_score": None, "soft_score": None}}
            if ctx.get("kind") == "scheduling":
                empty["days_to_employees"] = []
            return empty
        score = {"hard_score": hard, "soft_score": soft}
        if ctx.get("kind") == "nqueens":
            import numpy as np

            return {"score": score, "rows": np.asarray(assign.rows).tolist()}
        if ctx.get("kind") == "diagram":
            import numpy as np

            return {"score": score, "positions": np.asarray(assign).tolist()}
        start = ctx["start"]
        employees = ctx["employees"]
        days = []
        for i, emp_idx in enumerate(assign.tolist()):
            day = start + datetime.timedelta(days=i)
            label = f"{_WEEKDAYS[day.weekday()]} {day.isoformat()}"
            days.append([label, {"id": employees[emp_idx]}])
        return {"score": score, "days_to_employees": days}


class _Handler(BaseHTTPRequestHandler):
    service: SolverService = None  # set by run_server

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body, content_type="application/json"):
        data = (
            body.encode() if isinstance(body, str) else json.dumps(body).encode()
        )
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _route(self, method: str):
        parts = [p for p in self.path.split("/") if p]
        try:
            if method == "GET" and not parts:
                return self._send(200, _INDEX_HTML, "text/html")
            if parts[:2] == ["api", "solvers"]:
                if method == "POST" and len(parts) == 2:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    sid = self.service.create(payload)
                    return self._send(200, {"solverId": sid})
                if len(parts) >= 3:
                    sid = parts[2]
                    if method == "POST" and parts[3:] == ["round"]:
                        return self._send(200, self.service.round(sid))
                    if method == "GET" and parts[3:] == ["best"]:
                        return self._send(200, self.service.best(sid))
                    if method == "GET" and parts[3:] == ["info"]:
                        return self._send(200, self.service.info(sid))
                    if method == "GET" and parts[3:] == ["svg"]:
                        return self._send(
                            200, self.service.svg(sid), "image/svg+xml"
                        )
                    if method == "DELETE" and len(parts) == 3:
                        self.service.delete(sid)
                        return self._send(200, {"ok": True})
            return self._send(404, {"error": f"no route {method} {self.path}"})
        except KeyError as e:
            return self._send(404, {"error": f"unknown solver {e}"})
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return self._send(400, {"error": str(e)})

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")


def run_server(host="127.0.0.1", port=8787, service: SolverService | None = None):
    """Start the HTTP server (blocking).  Returns the server object if you
    run it on your own thread: ``srv = run_server(...); srv.serve_forever()``
    is handled internally when called directly."""
    handler = type("Handler", (_Handler,), {"service": service or SolverService()})
    server = ThreadingHTTPServer((host, port), handler)
    return server


_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Employee scheduling — solver service</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:52rem}
 fieldset{margin-bottom:1rem;border:1px solid #ccc;border-radius:6px}
 table{border-collapse:collapse;margin-top:1rem}
 td,th{border:1px solid #ddd;padding:2px 8px;font-size:0.9rem}
 button{margin-right:0.5rem}
 .score{font-weight:bold}
</style></head>
<body>
<h1>Employee scheduling</h1>
<p>Round-based incremental solve on the solver service — the browser UI
never blocks; each tick runs one ILS round (same contract as the reference
Web Worker loop).</p>
<fieldset><legend>Problem</legend>
 Start <input type="date" id="start" value="2022-05-09">
 End <input type="date" id="end" value="2022-06-08">
</fieldset>
<fieldset><legend>Employees</legend>
 <button id="addEmp">Add employee</button>
 <ul id="emps" style="list-style:none;padding-left:0"></ul>
 <small>Holidays: comma-separated ISO dates (e.g. 2022-05-12, 2022-05-13) —
 assigning an employee on their own holiday is a hard violation (H1).</small>
</fieldset>
<button id="startBtn">Start solving</button>
<button id="cancelBtn" disabled>Cancel</button>
<div id="progress"></div>
<div id="score" class="score"></div>
<table id="result"></table>
<script>
let solverId = null, cancelled = false, nextId = 0;
const $ = id => document.getElementById(id);
async function api(method, path, body) {
  const r = await fetch(path, {method, headers:{'Content-Type':'application/json'},
                               body: body ? JSON.stringify(body) : undefined});
  return r.json();
}
// Per-employee rows with holiday inputs + add/remove, the reference form
// capability (web/employee-scheduling/src/index.html:13-61, index.ts:20-60).
function addEmployee() {
  const id = nextId++;
  const li = document.createElement('li');
  li.dataset.empId = id;
  li.innerHTML = `<button class="rm">X</button> Employee ${id}
    holidays <input class="holidays" size="40" placeholder="2022-05-12, 2022-05-13">`;
  li.querySelector('.rm').onclick = () => li.remove();
  $('emps').appendChild(li);
}
$('addEmp').onclick = addEmployee;
for (let i = 0; i < 7; i++) addEmployee();  // reference default: 7 employees
$('startBtn').onclick = async () => {
  cancelled = false; $('startBtn').disabled = true; $('cancelBtn').disabled = false;
  const rows = [...document.querySelectorAll('#emps li')];
  const employees = rows.map(li => ({id: +li.dataset.empId}));
  const employeeHolidays = rows.map(li =>
    li.querySelector('.holidays').value.split(',')
      .map(s => s.trim()).filter(s => s.length));
  const res = await api('POST','/api/solvers', {
    startDate: $('start').value, endDate: $('end').value,
    employees, employeeHolidays});
  if (res.error) {
    $('score').textContent = `error: ${res.error}`;
    $('startBtn').disabled = false; $('cancelBtn').disabled = true;
    return;
  }
  solverId = res.solverId;
  tick();
};
$('cancelBtn').onclick = async () => {
  cancelled = true; $('cancelBtn').disabled = true; $('startBtn').disabled = false;
  if (solverId) await api('DELETE', `/api/solvers/${solverId}`);
};
async function tick() {
  if (cancelled || !solverId) return;
  const r = await api('POST', `/api/solvers/${solverId}/round`);
  render(r);
  if (!r.isFinished && !cancelled) setTimeout(tick, 0);
  else { $('startBtn').disabled = false; $('cancelBtn').disabled = true; }
}
function render(r) {
  $('progress').textContent =
    `round ${r.iterationInfo.current} / ${r.iterationInfo.total}`;
  $('score').textContent =
    `hard ${r.result.score.hard_score}  soft ${r.result.score.soft_score}`;
  $('result').innerHTML = '<tr><th>day</th><th>employee</th></tr>' +
    r.result.days_to_employees.map(([d,e]) =>
      `<tr><td>${d}</td><td>${e.id}</td></tr>`).join('');
}
</script></body></html>
"""


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Solver HTTP service")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    import torch

    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"device: {args.device} ({name})", flush=True)
    server = run_server(args.host, args.port, SolverService(args.device))
    # Report the BOUND port (--port 0 asks the OS for a free one).
    print(f"serving on http://{args.host}:{server.server_address[1]}",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
