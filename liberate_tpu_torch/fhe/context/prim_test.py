"""Primality testing.

The reference uses a randomized 10-round Miller-Rabin
(reference: src/liberate/fhe/context/prim_test.py:4). We use the
*deterministic* Miller-Rabin witness set that is exact for all n < 3.3e24
(covers every 64-bit integer), so prime generation is reproducible across
runs and hosts — a requirement for deterministic multi-host parameter setup.
"""

# Deterministic witnesses for n < 3,317,044,064,679,887,385,961,981.
_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)


def miller_rabin(n: int, rounds: int | None = None) -> bool:
    """Exact primality test for n < 2^64 (and far beyond).

    ``rounds`` is accepted for API compatibility and ignored; the witness
    set is deterministic and exact in the relevant range.
    """
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n == p:
            return True
        if n % p == 0:
            return False

    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1

    for a in _WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


# Alias matching the reference's public name.
MillerRabinPrimalityTest = miller_rabin
