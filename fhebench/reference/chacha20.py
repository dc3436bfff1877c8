"""ChaCha20 in NumPy and the secret key drawn from it.

The engine seeds a counter-mode ChaCha20 stream (the original layout: four
constants, eight key words, a 64-bit block counter, two nonce words) and
draws its uniform ternary secret as the first draw of its first shared
stream. This file repeats that draw from the seed alone.
"""

import hashlib

import numpy as np

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
QUARTER_ROUNDS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                  (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                  (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def keystream(key, nonce, counters):
    """ChaCha20 blocks [len(counters), 16] (uint32) for 64-bit counters."""
    counters = np.asarray(counters, dtype=np.uint64)
    n = counters.size

    def full(v):
        return np.full(n, v, dtype=np.uint32)

    state = ([full(c) for c in CONSTANTS] + [full(k) for k in key]
             + [(counters & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (counters >> np.uint64(32)).astype(np.uint32)]
             + [full(v) for v in nonce])
    x = [s.copy() for s in state]
    with np.errstate(over="ignore"):
        for _ in range(10):
            for a, b, c, d in QUARTER_ROUNDS:
                x[a] += x[b]
                x[d] = _rotl(x[d] ^ x[a], 16)
                x[c] += x[d]
                x[b] = _rotl(x[b] ^ x[c], 12)
                x[a] += x[b]
                x[d] = _rotl(x[d] ^ x[a], 8)
                x[c] += x[d]
                x[b] = _rotl(x[b] ^ x[c], 7)
        return np.stack([xi + si for xi, si in zip(x, state)], axis=-1)


def seed_words(seed):
    """The stream's key (8 words) and nonce (2 words) of an integer seed:
    the seed's 32-bit words, and the first 8 bytes of SHA-256 over the
    key's bytes and b"nonce"."""
    key = np.array([(seed >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                   dtype=np.uint32)
    digest = hashlib.sha256(key.astype("<u4").tobytes() + b"nonce").digest()
    nonce = np.frombuffer(digest[:8], dtype="<u4")
    return [int(k) for k in key], [int(v) for v in nonce]


def secret_key(seed, N, num_ordinary, num_special):
    """The engine's secret key of ``seed``: N coefficients in {-1, 0, 1}.

    The stream has one channel per ordinary prime, max(num_special, 2)
    shared channels and one for rounding; channel c's first draw reads
    blocks c*L .. c*L + L - 1 (L = N/4, four words a 128-bit sample x),
    and a sample is floor(3 x / 2^128) - 1."""
    L = N // 4
    channels = num_ordinary + max(num_special, 2) + 1
    assert channels > num_ordinary
    ch = num_ordinary
    key, nonce = seed_words(seed)
    words = keystream(key, nonce,
                      np.arange(L, dtype=np.uint64) + np.uint64(ch * L))
    w = words.reshape(-1, 4).astype(object)
    x = (((w[:, 2] << 32) | w[:, 3]) << 64) | (w[:, 0] << 32) | w[:, 1]
    return np.array([(3 * int(v)) >> 128 for v in x], dtype=np.int64) - 1
