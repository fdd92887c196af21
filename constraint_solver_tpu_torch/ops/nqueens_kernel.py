"""The N-Queens neighborhood-scoring kernel: CUDA on the card, plain PyTorch on the CPU.

Port of ``constraint_solver_tpu/ops/nqueens_pallas.py``.  For each lane, each of
A sampled columns j and every row r′:

    score = cur + 2·((rc[r′]−[r′=r_j]) + (dc[r′−c_j+n−1]−[r′=r_j])
                     + (ac[r′+c_j]−[r′=r_j]) − removed_j)

plus each row's minimum and its first-index argmin.  Every value is a small
integer in float32, so both versions are exact and equal the TPU kernel bit for bit.

- ``nqueens_neighborhood_scores`` is the wrapper.  It checks device, dtype, shape
  and contiguity, then takes the plain version for tensors on the CPU, and for
  tensors on a CUDA device launches the kernel in ``csrc/nqueens_scores.cu`` or
  raises: there is no fallback.  ``nqueens_neighborhood_scores.launches`` counts
  its kernel launches.
- ``nqueens_neighborhood_scores_ref`` is the plain version: windowed gathers of
  the diagonal tables, ``amin`` and first-index ``argmin``.
- ``build_library`` compiles the kernel with ``nvcc`` into ``build/kernels/`` at
  the checkout's root on first use (again whenever the source is newer than the
  library) and loads it with ``ctypes``.

Divergences from the TPU kernel: one call covers all P lanes (the JAX package
calls its kernel per lane under ``vmap``); ``cur`` is float32[P]; the unused
``rows`` argument is gone; and one row-min path covers every n.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "nqueens_scores.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_PATH = _BUILD_DIR / "libnqueens_scores.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_MAX_LANES = 65535  # the grid's y dimension

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel is built with the CUDA toolkit")
    return nvcc


def build_library(force: bool = False) -> str:
    """Compile ``csrc/nqueens_scores.cu`` into ``build/kernels/`` if the library
    is missing, older than its source, or ``force`` is set.  Returns the
    compiler's report (``-Xptxas=-v``: registers, shared memory, spills), or ""
    when the library was up to date."""
    if not force and _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)  # atomic: a concurrent loader never sees half a file
    return proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build_library()
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.nqueens_scores_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        lib.nqueens_scores_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rc, dc, ac, c, r, removed, cur) -> tuple[int, int, int]:
    if rc.dim() != 2 or c.dim() != 2:
        raise ValueError(f"rc must be [P, n] and c [P, A], got {tuple(rc.shape)} and {tuple(c.shape)}")
    p, n = rc.shape
    a = c.shape[1]
    want = {
        "rc": (rc, torch.float32, (p, n)),
        "dc": (dc, torch.float32, (p, 2 * n - 1)),
        "ac": (ac, torch.float32, (p, 2 * n - 1)),
        "c": (c, torch.int32, (p, a)),
        "r": (r, torch.int32, (p, a)),
        "removed": (removed, torch.float32, (p, a)),
        "cur": (cur, torch.float32, (p,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != rc.device:
            raise ValueError(f"{name} is on {t.device}, rc on {rc.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return p, a, n


def nqueens_neighborhood_scores_ref(rc, dc, ac, c, r, removed, cur):
    """Plain PyTorch version.  Returns (scores float32[P, A, n],
    row_min float32[P, A], row_arg int32[P, A])."""
    p, n = rc.shape
    a = c.shape[1]
    rp = torch.arange(n, device=rc.device)
    c = c.long()
    dc_at = dc.gather(1, ((n - 1) - c).unsqueeze(-1).add(rp).reshape(p, a * n)).view(p, a, n)
    ac_at = ac.gather(1, c.unsqueeze(-1).add(rp).reshape(p, a * n)).view(p, a, n)
    same = (rp == r.long().unsqueeze(-1)).to(torch.float32)
    added = (rc.unsqueeze(1) - same) + (dc_at - same) + (ac_at - same)
    scores = cur[:, None, None] + 2.0 * (added - removed.unsqueeze(-1))
    return scores, scores.amin(dim=-1), scores.argmin(dim=-1).to(torch.int32)


def nqueens_neighborhood_scores(rc, dc, ac, c, r, removed, cur):
    """The candidate block of every lane.  Inputs: rc float32[P, n], dc/ac
    float32[P, 2n−1], c/r int32[P, A], removed float32[P, A], cur float32[P],
    all contiguous and on one device.  Returns (scores float32[P, A, n],
    row_min float32[P, A], row_arg int32[P, A])."""
    p, a, n = _check(rc, dc, ac, c, r, removed, cur)
    device = rc.device
    if device.type == "cpu":
        return nqueens_neighborhood_scores_ref(rc, dc, ac, c, r, removed, cur)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if p > _MAX_LANES:
        raise ValueError(f"at most {_MAX_LANES} lanes per launch, got {p}")
    scores = torch.empty((p, a, n), dtype=torch.float32, device=device)
    row_min = torch.empty((p, a), dtype=torch.float32, device=device)
    row_arg = torch.empty((p, a), dtype=torch.int32, device=device)
    if p * a == 0:
        return scores, row_min, row_arg
    lib = _library()
    with torch.cuda.device(device):
        err = lib.nqueens_scores_launch(
            rc.data_ptr(), dc.data_ptr(), ac.data_ptr(), c.data_ptr(), r.data_ptr(),
            removed.data_ptr(), cur.data_ptr(), scores.data_ptr(), row_min.data_ptr(),
            row_arg.data_ptr(), p, a, n, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nqueens_scores_launch failed: cudaGetLastError() = {err}")
    nqueens_neighborhood_scores.launches += 1
    return scores, row_min, row_arg


nqueens_neighborhood_scores.launches = 0
