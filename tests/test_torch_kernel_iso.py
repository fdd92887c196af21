"""The probe kernels of ``bench/kernel_iso.py`` and their harness in the port
(``ops/nqueens_probes.py``, ``bench/kernel_iso.py``), against the JAX harness on the CPU.

The JAX harness is loaded from its file with its module globals set per case
(``N``, ``A``, ``K``, and ``INTERP`` for Pallas's interpret mode).  Each
kernel's per-call ``run`` is reached through the closure of its ``loop`` and
mapped over the lanes.  Inputs come from numpy with a fixed seed through both
packages' ``build_state``.  Every value is a small integer in float32 or int16,
so the comparisons are exact: the port's plain versions equal the TPU kernels
on the whole padded [P, A, n_pad] block (padding columns included) and on the
row min and argmin, and the port's loops equal the JAX loops.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``); here their
launch plans, their work by formula and the wrappers' refusal to fall back are
checked."""

import importlib.util
import inspect
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constraint_solver_tpu.models.nqueens import build_state as jax_build_state
from constraint_solver_tpu_torch.bench import kernel_iso
from constraint_solver_tpu_torch.models.nqueens import build_state
from constraint_solver_tpu_torch.ops import nqueens_kernel as nk
from constraint_solver_tpu_torch.ops import nqueens_probes as npr
from constraint_solver_tpu_torch.utils import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_LIMIT = 232_448  # the shared memory one block may use on Hopper


@pytest.fixture(scope="module")
def iso():
    spec = importlib.util.spec_from_file_location("jax_kernel_iso", os.path.join(REPO, "bench", "kernel_iso.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.INTERP = True
    return module


def _builds(iso):
    """Each probe's JAX harness build, as ``bench/kernel_iso.py`` ``main`` makes it."""
    return {
        "kern_base": lambda: iso.build(iso._kern_base),
        "kern_noroll": lambda: iso.build(iso._kern_noroll),
        "kern_i16": lambda: iso.build(iso._kern_i16, i16=True),
        "kern_i16min": lambda: iso.build(iso._kern_i16min, i16=True, with_min=True),
        "kern_packed": iso.build_packed,
    }


def _inputs(n, p, a, seed):
    """Random boards, A distinct columns per lane, their rows, removed terms and
    totals, as numpy; the tables through both packages' ``build_state``."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=(p, n)).astype(np.int32)
    c = np.argsort(rng.random((p, n)), axis=1)[:, :a].astype(np.int32)
    r = np.take_along_axis(rows, c, 1)
    rem = rng.integers(0, 6, size=(p, a)).astype(np.float32)
    cur = rng.integers(0, 60, size=(p,)).astype(np.float32)
    js = jax.vmap(jax_build_state)(jnp.asarray(rows))
    ts = build_state(torch.as_tensor(rows))
    for x, y in zip((js.rc, js.dc, js.ac), (ts.rc, ts.dc, ts.ac)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    jax_args = (js.rc, js.dc, js.ac, jnp.asarray(c), jnp.asarray(r), jnp.asarray(rem), jnp.asarray(cur))
    torch_args = (ts.rc, ts.dc, ts.ac, *(torch.as_tensor(x) for x in (c, r, rem, cur)))
    return jax_args, torch_args


def _assert_bit_equal(jax_outs, torch_outs):
    assert len(jax_outs) == len(torch_outs)
    for x, y in zip(jax_outs, torch_outs):
        x = np.asarray(x)
        assert x.dtype == y.numpy().dtype and x.shape == tuple(y.shape)
        assert x.tobytes() == y.numpy().tobytes()


@pytest.mark.parametrize("n, p", [(64, 3), (128, 2), (130, 3), (200, 2)])
@pytest.mark.parametrize("name", list(npr.PROBES))
def test_plain_version_equals_the_tpu_kernel(iso, name, n, p):
    a = max(3, n // 20)
    jax_args, torch_args = _inputs(n, p, a, seed=n + p)
    iso.N, iso.A = n, a
    run = inspect.getclosurevars(_builds(iso)[name]().__wrapped__.__wrapped__).nonlocals["run"]
    want = jax.vmap(run)(*jax_args)
    got = npr.WRAPPERS[name](*torch_args)  # CPU tensors: the plain version
    assert got[0].shape == (p, a, npr.padded(n))
    _assert_bit_equal(want, got)
    _assert_bit_equal(want, npr.REFS[name](*torch_args))


@pytest.mark.parametrize("name", ["kern_i16min", "kern_packed"])
def test_row_min_skips_the_padding_columns(iso, name):
    """rc of 4s, dc and ac of 2s: every valid column's three terms sum to at
    least 5, a padding column's (rc 0 there) to at most 4, so only the mask
    keeps the padding out of the min and argmin."""
    n, p, a = 130, 2, 4
    jax_args, torch_args = _inputs(n, p, a, seed=8)
    tables = [torch.full_like(t, v) for t, v in zip(torch_args[:3], (4.0, 2.0, 2.0))]
    torch_args = (*tables, *torch_args[3:])
    jax_args = (*(jnp.asarray(t.numpy()) for t in tables), *jax_args[3:])
    iso.N, iso.A = n, a
    run = inspect.getclosurevars(_builds(iso)[name]().__wrapped__.__wrapped__).nonlocals["run"]
    want = jax.vmap(run)(*jax_args)
    got = npr.WRAPPERS[name](*torch_args)
    _assert_bit_equal(want, got)
    assert torch.all(got[0].amin(dim=-1) < got[1]) and torch.all(got[2] < n)


@pytest.mark.parametrize(
    "variant", [*npr.PROBES, "slice", "conv", "toeplitz"],
)
def test_loop_equals_the_jax_harness(iso, variant):
    n, p, k = 64, 2, 3
    a = n // 20
    jax_args, torch_args = _inputs(n, p, a, seed=7)
    iso.N, iso.A, iso.K = n, a, k
    if variant in npr.PROBES:
        jax_loop = _builds(iso)[variant]()
        loop = kernel_iso.build_packed(k) if variant == "kern_packed" else kernel_iso.build(npr.WRAPPERS[variant], k)
    else:
        jax_loop, loop = iso.build_xla(variant), kernel_iso.build_xla(variant, k)
    want = jax_loop(*jax_args, jnp.arange(p))
    _assert_bit_equal([want], [loop(*torch_args)])


def test_packed_equals_i16min_on_the_whole_block():
    _, args = _inputs(200, 3, 10, seed=3)
    for x, y in zip(npr.kern_packed(*args), npr.kern_i16min(*args)):
        assert torch.equal(x, y)
    assert not torch.equal(npr.kern_noroll(*args)[0], npr.kern_base(*args)[0])  # wrong by design


def test_packed_table_holds_dc_low_and_reversed_ac_high():
    _, (rc, dc, ac, *_) = _inputs(130, 2, 6, seed=4)
    n, n_pad = 130, 256
    rc_p, dac = npr.prepare_tables("packed", rc, dc, ac)
    assert rc_p.dtype == torch.float32 and dac.dtype == torch.int32 and dac.shape == (2, 2 * n_pad)
    assert torch.equal((dac[:, : 2 * n - 1] & 0xFFFF).float(), dc)
    for t in range(2 * n_pad):
        src = n + n_pad - 2 - t
        want = ac[:, src] if 0 <= src <= 2 * n - 2 else torch.zeros(2)
        assert torch.equal((dac[:, t] >> 16).float(), want)


PLAN_SHAPES = [
    (256, 50, 1000), (16, 819, 16384), (4, 3, 8), (1, 1, 1), (3, 13, 130), (1, 1000, 1000),
    (2, 3, 11520), (2, 3, 11521), (1, 5, 19328), (1, 5, 19329), (1, 5, 23168), (1, 5, 23169),
]


@pytest.mark.parametrize("p, a, n", PLAN_SHAPES)
@pytest.mark.parametrize("name", list(npr.PROBES))
def test_launch_plan_covers_every_column_once_and_stages_where_the_format_fits(name, p, a, n):
    plan = npr.launch_plan(name, p, a, n)
    assert plan == npr.launch_plan.__wrapped__(name, p, a, n)  # a pure function of its arguments
    g, (gx, gy) = plan.cols_per_block, plan.grid
    assert 1 <= g <= 8 and gy == p and (gx - 1) * g < a
    handled = Counter(bx * g + w for bx in range(gx) for w in range(g) if bx * g + w < a)
    assert set(handled) == set(range(a)) and set(handled.values()) == {1}
    assert gx * gy >= min(132, p * a)
    n_pad = -(-n // 128) * 128
    table = {"f32": 4 * 5 * n_pad, "i16": 2 * 5 * n_pad, "packed": (4 + 4 * 2) * n_pad}[npr.PROBES[name].table]
    assert plan.staged == (table <= SMEM_LIMIT)
    assert plan.smem_bytes == (table if plan.staged else 0) and plan.smem_bytes % 16 == 0


def test_staging_limits_at_n_16384():
    """At n = 16384 the f32 tables (327,680 B) exceed a block's shared memory;
    the int16 (163,840 B) and packed (196,608 B) ones fit."""
    plans = {name: npr.launch_plan(name, 16, 819, 16384) for name in npr.PROBES}
    assert [plans[k].staged for k in npr.PROBES] == [False, False, True, True, True]
    assert plans["kern_i16"].smem_bytes == 163_840 and plans["kern_packed"].smem_bytes == 196_608


@pytest.mark.parametrize(
    "name, shape, nbytes",
    [
        ("kern_base", (256, 50, 1000), 57_826_304), ("kern_noroll", (256, 50, 1000), 57_826_304),
        ("kern_i16", (256, 50, 1000), 55_204_864), ("kern_i16min", (256, 50, 1000), 55_307_264),
        ("kern_packed", (256, 50, 1000), 55_831_552), ("kern_base", (16, 819, 16384), 864_183_936),
        ("kern_i16min", (16, 819, 16384), 861_667_328), ("kern_packed", (16, 819, 16384), 862_191_616),
    ],
)
def test_probe_work_bytes(name, shape, nbytes):
    ops, got = npr.probe_work(name, *shape)
    assert got == nbytes
    p, a, n = shape
    assert ops == (8 + npr.PROBES[name].with_min + 2 * npr.PROBES[name].fixed_windows) * p * a * npr.padded(n)


def test_roofline_counts_each_call_by_formula():
    _, args = _inputs(64, 2, 3, seed=5)
    with roofline.counting() as count:
        npr.kern_i16min(*args)
        npr.kern_i16min(*args)
    entry = count.kernels["kern_i16min"]
    assert entry["calls"] == 2 and entry["bytes"] == 2 * npr.probe_work("kern_i16min", 2, 3, 64)[1]


def test_wrappers_take_no_fallback_off_the_cpu(monkeypatch, tmp_path):
    """Tensors off the CPU never get the plain version: a device without a
    kernel raises, and on a machine without the CUDA toolkit the kernel's
    build raises too (a CUDA tensor cannot be made without a card)."""
    _, args = _inputs(64, 2, 3, seed=6)
    meta = [t.to("meta") for t in args]
    for fn in npr.WRAPPERS.values():
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(*meta)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(nk, "_nvcc", no_nvcc)
    monkeypatch.setattr(npr, "_LIB_PATH", tmp_path / "libnqueens_probes.so")
    monkeypatch.setattr(npr, "_launch_fns", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        npr._launchers()
    with pytest.raises(TypeError):
        npr.kern_base(*args[:3], args[3].long(), *args[4:])


def test_int16_probes_refuse_boards_whose_counts_may_not_fit():
    n = npr.INT16_MAX_N + 1
    rc, dc, ac = torch.zeros(1, n), torch.zeros(1, 2 * n - 1), torch.zeros(1, 2 * n - 1)
    c = r = torch.zeros(1, 1, dtype=torch.int32)
    for name in ("kern_i16", "kern_i16min", "kern_packed"):
        with pytest.raises(ValueError, match="16 bits"):
            npr.WRAPPERS[name](rc, dc, ac, c, r, torch.zeros(1, 1), torch.zeros(1))


def test_main_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        kernel_iso.main([])


def test_main_on_the_cpu_prints_one_line_per_arm(capsys):
    out = kernel_iso.main(["--device", "cpu", "--n", "64", "--p", "2", "--k", "2", "--packed", "--i16", "--mxu"])
    lines = capsys.readouterr().out.splitlines()
    arms = ["base f32", "noroll (timing only)", "packed 1-roll + min", "i16 tables", "i16 + row min/argmin",
            "torch slice block", "torch conv block", "torch toeplitz block"]
    assert list(out["arms"]) == arms
    assert lines[:2] == ["device: cpu", "n=64 P=2 A=3 K=2"]
    for arm, line in zip(arms, lines[2:10]):
        assert line.startswith(f"{arm:24s} ") and line.endswith(" ms/iter") and "ms / 2 iters = " in line
    assert lines[10] == "packed-vs-f32 accumulated-min delta: 0.0"
    sums = {arm: res["acc"] for arm, res in out["arms"].items()}
    for arm in arms:
        if arm != "noroll (timing only)":
            assert torch.equal(sums[arm], sums["base f32"])
