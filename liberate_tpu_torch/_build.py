"""Build and load the port's native code.

Each CUDA source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded with
``ctypes``. The sources include no PyTorch headers, so a build takes seconds.
The host math of the context (``native/hostmath.cpp``) is compiled the same
way by the host C++ compiler (``g++``, the one nvcc uses). Libraries are
named by a hash of their sources and flags and reused while it matches.

The build directory is ``build/liberate_tpu_torch`` beside the package, or
``$LIBERATE_TPU_TORCH_BUILD``. Each build writes to a name of its own process
and thread and then renames the library onto its hashed name, so processes
that build the same library at once each load a whole one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
SOURCES = {"ntt": "ntt.cu", "ksk_mulacc": "ksk_mulacc.cu",
           "ntt_mulacc": "ntt_mulacc.cu", "mxu_ntt": "mxu_ntt.cu",
           "mxu_switch": "mxu_switch.cu", "mod_down": "mod_down.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Host libraries: name -> source, compiled by CXX.
HOST_SOURCES = {"hostmath": PKG / "native" / "hostmath.cpp"}
CXX = "g++"
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_libs = {}
# Ranks that run as threads (liberate_tpu_torch.parallel) may reach a kernel
# together: one of them builds and loads it.
_lock = threading.Lock()


def build_dir() -> Path:
    d = os.environ.get("LIBERATE_TPU_TORCH_BUILD")
    return Path(d) if d else PKG.parent / "build" / "liberate_tpu_torch"


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    return found


def cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"host C++ compiler {CXX!r} not found: the "
                           f"context's host math (native/hostmath.cpp) is "
                           f"compiled at first use")
    return found


def _lib_path(name: str) -> Path:
    if name in HOST_SOURCES:
        h = hashlib.sha256(" ".join([CXX, *HOST_FLAGS]).encode())
        h.update(HOST_SOURCES[name].read_bytes())
    else:
        h = hashlib.sha256(" ".join(FLAGS).encode())
        for src in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
            h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        return [cxx(), *HOST_FLAGS, "-o", str(out), str(HOST_SOURCES[name])]
    return [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / SOURCES[name])]


def build(names=None):
    """Compile the named libraries (default: every CUDA kernel) that are not
    built yet, one compiler process per source, all started together. Each
    compiler log (nvcc's with ``-Xptxas -v``'s register and shared-memory
    report) is kept beside its library. Raises with the logs of the builds
    that failed. Returns {name: library path}."""
    names = list(SOURCES) if names is None else list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    tag = f"{os.getpid()}.{threading.get_ident()}"
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_name(f"{p.stem}.{tag}.tmp.so")
        log = p.with_name(f"{p.stem}.{tag}.log")
        with open(log, "w") as f:
            procs[n] = (subprocess.Popen(_command(n, tmp), stdout=f,
                                         stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        text = log.read_text()
        os.replace(log, paths[n].with_suffix(".log"))
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n}: {Path(proc.args[0]).name} exit {rc}\n{text}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(build([name])[name]))
            lib = _libs[name]
    return lib
