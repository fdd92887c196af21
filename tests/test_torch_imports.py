"""The port imports nothing of JAX and nothing of the JAX package.

In a fresh interpreter, a meta-path finder raises ``ImportError`` for ``jax``
and for ``constraint_solver_tpu`` (and their submodules), then every module of
``constraint_solver_tpu_torch`` (``cli.*``, ``serve.server`` and ``diagram.*``
included) and ``chip_smoke`` are imported.  Each import must succeed and no
blocked module may be loaded afterwards."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, importlib.abc, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "constraint_solver_tpu")
attempts = []


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            attempts.append(name)
            raise ImportError(f"{name} is blocked: the port must not import it")
        return None


sys.meta_path.insert(0, Block())
import constraint_solver_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")] + ["chip_smoke"]
failed = {}
for name in names:
    try:
        importlib.import_module(name)
    except Exception as e:  # noqa: BLE001 — reported to the test
        failed[name] = repr(e)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"names": names, "failed": failed, "loaded": loaded, "attempts": attempts}))
"""


def test_port_and_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["failed"] == {}
    assert out["loaded"] == []
    # Every module of the port is reached, the user surface included.
    for name in ("constraint_solver_tpu_torch.cli.nqueens", "constraint_solver_tpu_torch.cli.scheduling",
                 "constraint_solver_tpu_torch.cli.qap", "constraint_solver_tpu_torch.cli.ackley",
                 "constraint_solver_tpu_torch.cli.diagram", "constraint_solver_tpu_torch.serve.server",
                 "constraint_solver_tpu_torch.diagram.geometry", "constraint_solver_tpu_torch.diagram.route",
                 "constraint_solver_tpu_torch.diagram.png", "constraint_solver_tpu_torch.utils.roofline",
                 "constraint_solver_tpu_torch.utils.profiling", "constraint_solver_tpu_torch.utils.printing",
                 "constraint_solver_tpu_torch.parallel.mesh", "constraint_solver_tpu_torch.parallel.distributed",
                 "constraint_solver_tpu_torch.parallel.sharded", "constraint_solver_tpu_torch.parallel.seq_shard",
                 "constraint_solver_tpu_torch.parallel.seq_solver", "chip_smoke"):
        assert name in out["names"]


def test_multi_device_layer_and_smoke_name_no_jax():
    """No import statement in ``parallel/`` or ``chip_smoke.py`` names JAX or
    the JAX package, at any depth (a function-level import included)."""
    import ast
    import glob

    files = glob.glob(os.path.join(REPO, "constraint_solver_tpu_torch", "parallel", "*.py"))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) >= 8
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(roots) & {"jax", "jaxlib", "constraint_solver_tpu"}, (path, node.lineno)
