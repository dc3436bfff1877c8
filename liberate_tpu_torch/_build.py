"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, and loaded with ``ctypes``.
The sources include no PyTorch headers, so a build takes seconds. Libraries
are named by a hash of their sources and flags and reused while it matches.

The build directory is ``build/liberate_tpu_torch`` beside the package, or
``$LIBERATE_TPU_TORCH_BUILD``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"ntt": "ntt.cu", "ksk_mulacc": "ksk_mulacc.cu",
           "ntt_mulacc": "ntt_mulacc.cu", "mxu_ntt": "mxu_ntt.cu",
           "mxu_switch": "mxu_switch.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
# Ranks that run as threads (liberate_tpu_torch.parallel) may reach a kernel
# together: one of them builds and loads it.
_lock = threading.Lock()


def build_dir() -> Path:
    d = os.environ.get("LIBERATE_TPU_TORCH_BUILD")
    return Path(d) if d else (
        Path(__file__).resolve().parent.parent / "build" / "liberate_tpu_torch")


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all started together. Each compiler log
    (with ``-Xptxas -v``'s register and shared-memory report) is kept
    beside its library. Returns {name: library path}."""
    names = list(SOURCES) if names is None else list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_suffix(".tmp.so")
        log = open(p.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / SOURCES[n])],
            stdout=log, stderr=subprocess.STDOUT), tmp, p, log)
    failed = []
    for n, (proc, tmp, p, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{n}: nvcc exit {rc}\n"
                          + p.with_suffix(".log").read_text())
        else:
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(build([name])[name]))
            lib = _libs[name]
    return lib
