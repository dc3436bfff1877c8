"""The kernel formulas (``kernels/<wrapper>.py``) and the recorder that
applies them to a traced window.

A formula file is named after one of the port's kernel wrappers and
holds ``MODULE`` (the module that defines the wrapper), ``shape(*args,
**kwargs)`` (the shapes of one call, from its arguments) and
``work(shape)`` (bytes, 32-bit multiplies and int8 multiply-accumulates
that call needs: each input byte read once, each output byte written
once). While the recorder is on, each call of a wrapper that has a file
is recorded with its bound; calls still run the port's own code.
"""

import importlib
import importlib.util
from pathlib import Path

from . import costs

KERNELS = Path(__file__).resolve().parent.parent / "kernels"


def load(name, folder=KERNELS):
    spec = importlib.util.spec_from_file_location(
        f"fhebench_kernel_{name}", folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def formulas(folder=KERNELS):
    return {p.stem: load(p.stem, folder) for p in sorted(folder.glob("*.py"))
            if not p.stem.startswith("_")}


def call_bound(formula, shape):
    """(seconds, what bounds it) of one call."""
    return costs.bound(*formula.work(shape))


class Recorder:
    """Context manager: records (wrapper, bound seconds) of every call of a
    wrapper that has a formula."""

    def __init__(self, folder=KERNELS):
        self.formulas = formulas(folder)
        self.calls = []
        self._saved = []

    def __enter__(self):
        for name, f in self.formulas.items():
            module = importlib.import_module(f.MODULE)
            orig = getattr(module, name)

            def wrapper(*args, _orig=orig, _name=name, _f=f, **kwargs):
                self.calls.append(
                    (_name, call_bound(_f, _f.shape(*args, **kwargs))[0]))
                return _orig(*args, **kwargs)

            self._saved.append((module, name, orig))
            setattr(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved.clear()
        return False

    def bound_s(self):
        return sum(b for _, b in self.calls)
