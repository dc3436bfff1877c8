"""Error statistics of decoded messages (reference:
src/liberate/utils/helpers.py)."""

import numpy as np


def random_complex_array(n, amin=-1.0, amax=1.0, decimal_places: int = 10):
    base = 10 ** decimal_places
    a = np.random.randint(amin * base, amax * base, n) / base
    b = np.random.randint(amin * base, amax * base, n) / base
    return a + b * 1j


def absmax_error(x, y):
    """Max absolute error; complex errors reported as real + imag*1j."""
    x = np.asarray(x)
    y = np.asarray(y)
    if np.iscomplexobj(x) and np.iscomplexobj(y):
        return (np.abs(x.real - y.real).max()
                + np.abs(x.imag - y.imag).max() * 1j)
    return np.abs(x - y).max()


def check_errors(x, y, plot=False):
    """Print (and with ``plot``, plot with matplotlib where it is
    installed) the statistics of |x - y|; returns |x - y|."""
    x = np.asarray(x)
    y = np.asarray(y)
    err = np.abs(x - y)
    print(f"absmax error: {err.max():.3e}")
    print(f"mean error:   {err.mean():.3e}")
    print(f"std error:    {err.std():.3e}")
    if plot:
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping plot")
        else:
            plt.hist(err.ravel(), bins=64)
            plt.xlabel("absolute error")
            plt.ylabel("count")
            plt.show()
    return err
