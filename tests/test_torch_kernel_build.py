"""The N-Queens kernel's lazy build and load are thread-safe
(``ops/nqueens_kernel.py`` ``_launcher`` and ``build_library``).

The server's handler threads can reach the kernel's first use together.  Here
the compiler call and the ``ctypes`` load are replaced by recorders (there is
no ``nvcc`` on the CPU), the build directory is a temporary one, and threads
call ``_launcher()`` at once, with a short switch interval so that they
interleave: the library must be compiled and loaded once, every thread must
get the same entry point, and the compiler's temporary file must be named by
process and thread."""

import os
import sys
import threading
import time

import pytest

from constraint_solver_tpu_torch.ops import nqueens_kernel as nk

THREADS = 8


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    compiled, loaded = [], []

    def run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        compiled.append((out, threading.get_ident()))
        time.sleep(0.05)  # a compile takes a while: let the other threads reach the lock
        with open(out, "w") as f:
            f.write("library")
        return nk.subprocess.CompletedProcess(cmd, 0, "", "")

    class Library:
        def __init__(self, path):
            loaded.append(path)
            self.nqueens_scores_launch = object.__new__(type("Entry", (), {}))

    monkeypatch.setattr(nk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nk.subprocess, "run", run)
    monkeypatch.setattr(nk.ctypes, "CDLL", Library)
    monkeypatch.setattr(nk, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nk, "_LIB_PATH", tmp_path / "libnqueens_scores.so")
    monkeypatch.setattr(nk, "_launch_fn", None)
    return compiled, loaded


def test_concurrent_first_use_builds_once(fake_toolchain):
    compiled, loaded = fake_toolchain
    barrier = threading.Barrier(THREADS)
    got, errors = [], []

    def first_use():
        try:
            barrier.wait(timeout=30)
            got.append(nk._launcher())
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(compiled) == 1 and len(loaded) == 1
    assert len(got) == THREADS and all(fn is got[0] for fn in got)
    tmp, ident = compiled[0]
    assert os.path.basename(tmp) == f"libnqueens_scores.so.{os.getpid()}.{ident}.tmp"
    assert not os.path.exists(tmp) and nk._LIB_PATH.exists()  # renamed into place


def test_build_library_is_skipped_when_up_to_date_and_forced_again(fake_toolchain):
    compiled, _ = fake_toolchain
    nk.build_library()
    assert nk.build_library() == "" and len(compiled) == 1
    nk.build_library(force=True)
    assert len(compiled) == 2
