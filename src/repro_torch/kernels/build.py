"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library ``_build/<name>-<hash>.so`` inside the package (``.gitignore``
lists ``_build/``); the hash covers the source and the flags, so an edited
source is never served by a stale build.  Building happens at first use of
a kernel, or for all sources at once through :func:`build_all`, which starts
one ``nvcc`` per source together and waits for them all.  Nothing here runs
at import time: a machine without ``nvcc`` imports every module and only a
kernel launch fails.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "load_library", "build_log",
           "ticket_counters"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("segment_agg", "flash_attention", "flash_attention_bwd", "rmsnorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# ptxas resource report (registers, spills); changes nothing in the binary
_REPORT_FLAGS = ("-Xptxas=-v",)

_LIBS: dict[str, ctypes.CDLL] = {}
# each kernel's ticket counters per device (see ticket_counters)
_TICKETS: dict[tuple[str, torch.device], torch.Tensor] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_log(name: str) -> str:
    """The compiler's output (ptxas register report) of ``name``'s build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every source in ``names`` that has no current build, all
    ``nvcc`` processes started together; raises if any fails."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, t in todo.items():
        tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *_REPORT_FLAGS, "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        todo[n].with_suffix(".log").write_text(out)
        os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return targets


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all((name,))[name]))
    return lib


def ticket_counters(kernel: str, device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 ticket counters for ``kernel`` on
    ``device``: one buffer per kernel and device, made once and kept while
    it is large enough, replaced by a zeroed one twice as large (or ``n``)
    when a call needs more.  A kernel that takes tickets sets each one
    back to 0 before it ends, so no launch needs a memset; calls of one
    kernel on one device share the buffer, so they run one after another
    on one stream."""
    key = (kernel, torch.device(device))
    have = _TICKETS.get(key)
    if have is None or have.numel() < n:
        size = max(int(n), 2 * (0 if have is None else have.numel()))
        have = _TICKETS[key] = torch.zeros(size, dtype=torch.int32,
                                           device=key[1])
    return have
