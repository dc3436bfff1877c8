"""The context's host math in C++ (``hostmath.cpp``), loaded with ctypes.

The library is compiled by the host C++ compiler at first use into the
port's build directory (``_build``); a failed build raises with the
compiler's log. The wrappers decline (return None) where an input lies
outside the library's range, below 2^63, and inside ``plain()``; the
context layer then takes its pure-Python twin. No preset reaches 2^63.
"""

import contextlib
import ctypes
import threading

import numpy as np

from .. import _build

LIMIT = 1 << 63

_u64, _i32 = ctypes.c_uint64, ctypes.c_int32
_p64 = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "miller_rabin_u64": (_i32, [_u64]),
    "find_ntt_prime": (_u64, [_u64, _u64, _i32]),
    "primitive_root_2N": (_u64, [_u64, _u64]),
    "psi_banks": (None, [_p64, _p64, _p64, _i32, _i32, _p64, _p64]),
}

_local = threading.local()


@contextlib.contextmanager
def plain():
    """In this block (this thread), every wrapper declines, so the context
    layer computes with its pure-Python twins: the twin of a context is
    ``with native.plain(): CkksContext(...)``."""
    before = getattr(_local, "plain", False)
    _local.plain = True
    try:
        yield
    finally:
        _local.plain = before


def _fn(name):
    """The library's function, its C signature declared; None in plain()."""
    if getattr(_local, "plain", False):
        return None
    fn = getattr(_build.load("hostmath"), name)
    if fn.argtypes is None:
        fn.restype, fn.argtypes = _SIGNATURES[name]
    return fn


def miller_rabin(n: int):
    """Is n prime (exact)? None if n is outside [0, 2^63)."""
    fn = _fn("miller_rabin_u64")
    if fn is None or not 0 <= n < LIMIT:
        return None
    return bool(fn(n))


def find_ntt_prime(start: int, M: int, up: bool):
    """The first prime q = 1 (mod M) from the odd ``start`` in steps of 2,
    upwards or downwards; None if the search leaves (2, 2^63)."""
    if start % 2 == 0 or M < 1:
        raise ValueError(f"find_ntt_prime: start {start} must be odd and M "
                         f"{M} positive")
    fn = _fn("find_ntt_prime")
    if fn is None or not 2 < start < LIMIT or M >= LIMIT:
        return None
    return int(fn(start, M, 1 if up else 0)) or None


def primitive_root_2N(q: int, N: int):
    """A primitive 2N-th root of unity mod the prime q = 1 (mod 2N); None if
    q is outside (2, 2^63)."""
    fn = _fn("primitive_root_2N")
    if fn is None or not 2 < q < LIMIT:
        return None
    return int(fn(q, N))


def psi_banks(qs, psis, ipsis, logN: int):
    """The bit-reversed power banks of psi and psi^-1 for every channel:
    (fwd, inv) uint64 [C, N]; None if a modulus is outside (2, 2^63)."""
    fn = _fn("psi_banks")
    if fn is None or not all(2 < q < LIMIT for q in qs):
        return None
    if not len(qs) == len(psis) == len(ipsis) or not 1 <= logN <= 30:
        raise ValueError(f"psi_banks: {len(qs)} moduli, {len(psis)} and "
                         f"{len(ipsis)} roots, logN {logN}")
    qs, psis, ipsis = (np.ascontiguousarray(a, dtype=np.uint64)
                       for a in (qs, psis, ipsis))
    fwd = np.empty((len(qs), 1 << logN), dtype=np.uint64)
    inv = np.empty_like(fwd)
    fn(*(a.ctypes.data_as(_p64) for a in (qs, psis, ipsis)), len(qs), logN,
       fwd.ctypes.data_as(_p64), inv.ctypes.data_as(_p64))
    return fwd, inv
