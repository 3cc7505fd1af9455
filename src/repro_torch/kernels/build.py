"""Build and load the port's CUDA kernels (no JAX counterpart: the JAX
package's Pallas kernels are compiled by XLA).

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing is compiled when a
module is imported. ``build_all()`` starts one ``nvcc`` per source at once
and waits for all of them; ``SECONDS`` holds each source's compile time.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; ``check()`` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("panel_qr", "wy_apply", "stacked_qr", "fused_sweep",
           "fused_panel_f32", "fused_panel_bf16", "wide", "panel_qr_wide",
           "fused_wide_bf16", "panel_qr_wide_bf16", "wide_bf16")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# Wall seconds of each source's nvcc in this process (sources compiled here).
SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "a machine with the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@functools.cache
def sources_digest() -> str:
    """A digest of every source the libraries are built from (the
    ``csrc/*.cu`` and ``*.cuh`` files) and the flags: what makes one build
    of the kernels differ from another."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target, start
    time) or None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    SECONDS[name] = time.perf_counter() - t0
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> List[pathlib.Path]:
    """Compile every listed source in parallel (one nvcc each); returns the
    library paths. Already-built libraries are reused."""
    names = list(names)
    started = {n: s for n in names if (s := _start(n)) is not None}

    def finish(item):
        try:
            _finish(*item)
        except RuntimeError as e:
            return str(e)
        return None

    # one waiter a process, so that each source's seconds end with its nvcc
    with ThreadPoolExecutor(max(len(started), 1)) as pool:
        errors = [e for e in pool.map(finish, started.items()) if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_target(n) for n in names]


def missing(names: Iterable[str] = SOURCES) -> List[str]:
    """The listed sources whose library is not built yet (a process that
    must not start nvcc, such as a rank of a lane group, checks this)."""
    return [n for n in names if not _target(n).exists()]


def resource_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel of ``csrc/<name>.cu``, read
    from the ``-Xptxas -v`` lines of its build log: {mangled kernel name:
    {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}."""
    out: Dict[str, Dict[str, int]] = {}
    entry = props = None
    for line in _target(name).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
            out[entry] = {}
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                             r"loads", line)) and entry and props == entry:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types set and an int result."""
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")
