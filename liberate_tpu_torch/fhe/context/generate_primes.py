"""NTT-friendly prime generation.

Reproduces the reference's prime-selection strategy
(reference: src/liberate/fhe/context/generate_primes.py):

- Message/special primes: NTT-friendly primes q = 1 (mod 2N) found by
  descending from 2^mb - 1 (:58-96). With a deterministic primality test,
  the resulting prime lists are identical to the reference's shipped caches.
- Scale primes: an alternating above/below-2^scale_bits sequence with a
  cumulative-deviation optimization so the running product of
  (scale / q_i) stays as close to 1 as possible (:116-203).

The searches run the native host math (``native/hostmath.cpp``) below 2^63;
``find_the_next_prime_plain`` is their pure-Python twin.

Results are memoized in-process and pickled in the cache folder.
"""

import math
import pickle
from pathlib import Path

from ... import native
from .prim_test import miller_rabin_plain
from .security_parameters import maximum_qbits

DEFAULT_LOGN_RANGE = list(range(6, 18))


def find_the_next_prime(start: int, m: int, up: bool = True) -> int:
    """The first prime q = 1 (mod m) from ``start`` in steps of 2, upwards
    or downwards (``start`` included)."""
    q = native.find_ntt_prime(start, m, up)
    return find_the_next_prime_plain(start, m, up) if q is None else q


def find_the_next_prime_plain(start: int, m: int, up: bool = True) -> int:
    """``find_the_next_prime`` in Python integers."""
    step = 2 if up else -2
    q = start
    while not ((q - 1) % m == 0 and miller_rabin_plain(q)):
        q += step
    return q


def descending_primes(mb: int, m: int, how_many: int) -> list:
    """The first ``how_many`` primes q = 1 (mod m) below 2^mb, descending."""
    primes = []
    q = 2 ** mb - 1
    while len(primes) < how_many:
        q = find_the_next_prime(q, m, up=False)
        primes.append(q)
        q -= 2
    return primes


def generate_message_primes(mbits=None, cache_folder=None, how_many=11, logN_range=None):
    """Descending NTT-friendly primes just below 2^mb for each N.

    Returns {mb: {N: [primes...]}}. The first prime is the base (decrypt)
    prime; the following ones serve as special primes.
    """
    if mbits is None:
        mbits = [28, 60]
    if logN_range is None:
        logN_range = DEFAULT_LOGN_RANGE

    savefile = None
    if cache_folder is not None:
        savefile = Path(cache_folder) / "message_special_primes.pkl"
        if savefile.exists():
            with savefile.open("rb") as f:
                return pickle.load(f)

    mprimes = {}
    for mb in mbits:
        mprimes[mb] = {}
        for logN in logN_range:
            N = 2 ** logN
            mprimes[mb][N] = descending_primes(mb, 2 * N, how_many)

    if savefile is not None:
        savefile.parent.mkdir(parents=True, exist_ok=True)
        with savefile.open("wb") as f:
            pickle.dump(mprimes, f)
    return mprimes


def generate_alternating_prime_sequence(
    sb: int = 40,
    N: int = 2 ** 15,
    how_many: int = 60,
    optimize: bool = True,
    alternate_directions: bool = True,
    fixed_direction: bool = False,
) -> list:
    """Scale primes alternating above/below 2^sb.

    With ``optimize``, the next search start is nudged so the cumulative
    deviation prod(scale/q_i) is driven back towards 1 (the reference's
    pre-rescale quadratic deviation rule,
    reference: src/liberate/fhe/context/generate_primes.py:160-174).
    """
    m = N * 2
    scale = 2 ** sb
    s_primes: list = []

    up = scale + 1
    down = scale - 1

    if not alternate_directions:
        q = up if fixed_direction else down
        step = 2 if fixed_direction else -2
        while len(s_primes) < how_many:
            q = find_the_next_prime(start=q, m=m, up=fixed_direction)
            s_primes.append(q)
            q += step
        return s_primes

    up0 = find_the_next_prime(start=up, m=m, up=True)
    down0 = find_the_next_prime(start=down, m=m, up=False)
    eup = up0 - scale
    edown = scale - down0
    # Next direction: if the first (smaller-error) candidate will be 'up',
    # the next is 'down', and vice versa.
    current_direction = not (eup < edown)

    cumulative_scale = 1.0
    while len(s_primes) < how_many:
        start = up if current_direction else down
        next_prime = find_the_next_prime(start=start, m=m, up=current_direction)

        # Pre-rescale quadratic deviation rule.
        current_dev = scale / next_prime
        cumulative_scale = cumulative_scale ** 2 * current_dev ** 2

        if current_direction:
            up = next_prime + 2
            if optimize:
                searched = int((cumulative_scale * scale) // 2 * 2 - 1)
                down = searched if searched < down else down
        else:
            down = next_prime - 2
            if optimize:
                searched = int((cumulative_scale * scale) // 2 * 2 + 1)
                up = searched if searched > up else up

        current_direction = not current_direction
        s_primes.append(next_prime)

    return s_primes


def maximum_levels(N: int, qbits: int = 40, mbits: int = 60, nksk: int = 2) -> int:
    extra_bits = mbits * (1 + nksk)
    return math.floor((maximum_qbits(N) - extra_bits) / qbits)


def _pgen_safe(sb, N, how_many):
    if how_many < 2:
        return []
    try:
        return generate_alternating_prime_sequence(sb=sb, N=N, how_many=how_many)
    except Exception:
        return _pgen_safe(sb, N, how_many // 2)


def generate_scale_primes(cache_folder=None, how_many=64, logN_range=None,
                          scale_bits_range=None):
    """Returns {(scale_bits, N): [primes...]} for the standard grid."""
    savefile = None
    if cache_folder is not None:
        savefile = Path(cache_folder) / "scale_primes.pkl"
        if savefile.exists():
            with savefile.open("rb") as f:
                return pickle.load(f)

    if logN_range is None:
        logN_range = DEFAULT_LOGN_RANGE
    if scale_bits_range is None:
        scale_bits_range = list(range(20, 55, 5))

    result = {}
    for logN in logN_range:
        N = 2 ** logN
        hm = how_many if logN < 16 else max(how_many, 128)
        for sb in scale_bits_range:
            result[(sb, N)] = _pgen_safe(sb, N, hm)

    if savefile is not None:
        savefile.parent.mkdir(parents=True, exist_ok=True)
        with savefile.open("wb") as f:
            pickle.dump(result, f)
    return result
