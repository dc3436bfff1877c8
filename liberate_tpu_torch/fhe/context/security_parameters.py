"""Security parameter tables.

Standard homomorphicencryption.org logq limit tables for security levels
{128, 192, 256} x {pre, post}-quantum x {uniform, error, ternary} secret
distributions, with linear interpolation/extrapolation over the ring
dimension N (reference: src/liberate/fhe/context/security_parameters.py).

We implement the linear spline directly (numpy) instead of depending on
scipy — the k=1 InterpolatedUnivariateSpline used by the reference is plain
piecewise-linear interpolation with linear extrapolation at the ends.
"""

import numpy as np

security_levels = [128, 192, 256]

# Ring dimensions n of Z[X]/(X^n + 1).
cyclotomic_n = [1024, 2048, 4096, 8192, 16384, 32768]

# Tables are interleaved by security level: for each n (ascending), the
# entries are (128-bit, 192-bit, 256-bit).
_logq_preq = {
    "uniform": [29, 21, 16, 56, 39, 31, 111, 77, 60, 220, 154, 120,
                440, 307, 239, 880, 612, 478],
    "error": [29, 21, 16, 56, 39, 31, 111, 77, 60, 220, 154, 120,
              440, 307, 239, 883, 613, 478],
    "ternary": [27, 19, 14, 54, 37, 29, 109, 75, 58, 218, 152, 118,
                438, 305, 237, 881, 611, 476],
}

_logq_postq = {
    "uniform": [27, 19, 15, 53, 37, 29, 103, 72, 56, 206, 143, 111,
                413, 286, 222, 829, 573, 445],
    "error": [27, 19, 15, 53, 37, 29, 103, 72, 56, 206, 143, 111,
              413, 286, 222, 829, 573, 445],
    "ternary": [25, 17, 13, 51, 35, 27, 101, 70, 54, 202, 141, 109,
                411, 284, 220, 827, 571, 443],
}


def _partition_by_level(table):
    n_lev = len(security_levels)
    return {
        lev: [table[i] for i in range(li, len(table), n_lev)]
        for li, lev in enumerate(security_levels)
    }


logq = {
    "pre_quantum": {d: _partition_by_level(t) for d, t in _logq_preq.items()},
    "post_quantum": {d: _partition_by_level(t) for d, t in _logq_postq.items()},
}


def _linear_spline(x, xs, ys):
    """Piecewise-linear interpolation with linear extrapolation at both ends."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    x = float(x)
    if x <= xs[0]:
        slope = (ys[1] - ys[0]) / (xs[1] - xs[0])
        return ys[0] + slope * (x - xs[0])
    if x >= xs[-1]:
        slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
        return ys[-1] + slope * (x - xs[-1])
    return float(np.interp(x, xs, ys))


def _check(quantum, distribution, security_bits):
    assert quantum in ("pre_quantum", "post_quantum"), "Wrong quantum security model!!!"
    assert distribution in ("uniform", "error", "ternary")
    assert security_bits in security_levels


def minimum_cyclotomic_order(q_bits, security_bits=128, quantum="post_quantum",
                             distribution="uniform"):
    """Smallest ring dimension N supporting q_bits of modulus at the security level."""
    _check(quantum, distribution, security_bits)
    x = logq[quantum][distribution][security_bits]
    return _linear_spline(q_bits, x, cyclotomic_n)


def maximum_qbits(L, security_bits=128, quantum="post_quantum",
                  distribution="uniform"):
    """Maximum total log2(q) allowed at ring dimension L for the security level."""
    _check(quantum, distribution, security_bits)
    y = logq[quantum][distribution][security_bits]
    return _linear_spline(L, cyclotomic_n, y)
