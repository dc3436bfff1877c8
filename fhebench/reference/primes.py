"""The primes of a configuration, worked out again from its parameters.

The library's rule (the upstream Liberate.FHE context): the base prime
and the special primes are the largest primes q = 1 (mod 2N) below
2^(word - 2), descending; the scale primes alternate above and below
2^scale_bits, each search start nudged so that the running product of
(2^scale_bits / q_i) stays near 1; with no number of scales given, as
many scale primes as the 128-bit post-quantum budget for a uniform
secret leaves beside the base and special primes. The modulus chain is
q = [scale_0 .. scale_{L-1}, base, special_0 .. special_{k-1}].
"""

import math

import numpy as np

# log2 q limits of the homomorphicencryption.org tables, 128-bit security,
# post-quantum, uniform secret, at N = 2^10 .. 2^15; linear beyond.
BUDGET_N = (1024, 2048, 4096, 8192, 16384, 32768)
BUDGET_BITS = (27, 53, 103, 206, 413, 829)

WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n):
    """Deterministic Miller-Rabin, exact below 3.3e24."""
    if n < 2:
        return False
    for p in WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def next_prime(start, m, up):
    """The first prime q = 1 (mod m) from ``start`` (included), upwards or
    downwards."""
    if up:
        q = start + (1 - start) % m
        step = m
    else:
        q = start - (start - 1) % m
        step = -m
    while not is_prime(q):
        q += step
    return q


def budget_bits(N):
    xs, ys = np.array(BUDGET_N, float), np.array(BUDGET_BITS, float)
    if N >= xs[-1]:
        return ys[-1] + (ys[-1] - ys[-2]) / (xs[-1] - xs[-2]) * (N - xs[-1])
    if N <= xs[0]:
        return ys[0] + (ys[1] - ys[0]) / (xs[1] - xs[0]) * (N - xs[0])
    return float(np.interp(N, xs, ys))


def scale_primes(scale_bits, N):
    """The alternating scale-prime sequence, as a generator."""
    m, scale = 2 * N, 2 ** scale_bits
    up, down = scale + 1, scale - 1
    up0, down0 = next_prime(up, m, True), next_prime(down, m, False)
    going_up = not (up0 - scale < scale - down0)
    cumulative = 1.0
    while True:
        q = next_prime(up if going_up else down, m, going_up)
        cumulative = cumulative ** 2 * (scale / q) ** 2
        if going_up:
            up = q + 2
            searched = int((cumulative * scale) // 2 * 2 - 1)
            down = min(searched, down)
        else:
            down = q - 2
            searched = int((cumulative * scale) // 2 * 2 + 1)
            up = max(searched, up)
        going_up = not going_up
        yield q


def modulus_chain(logN, scale_bits, num_special_primes, num_scales=None,
                  buffer_bit_length=62):
    """(q, num_scales): the primes in the order above."""
    N = 2 ** logN
    m = 2 * N
    message = []
    q = 2 ** (buffer_bit_length - 2) - 1
    while len(message) < 1 + num_special_primes:
        q = next_prime(q, m, False)
        message.append(q)
        q -= 2
    gen = scale_primes(scale_bits, N)
    scales = []
    if num_scales is None:
        bits = budget_bits(N) - sum(math.log2(p) for p in message)
        scales.append(next(gen))
        bits -= math.log2(scales[0])
        while bits > 0:
            scales.append(next(gen))
            bits -= math.log2(scales[-1])
        num_scales = len(scales) - 1
    while len(scales) < num_scales:
        scales.append(next(gen))
    return scales[:num_scales] + message, num_scales
