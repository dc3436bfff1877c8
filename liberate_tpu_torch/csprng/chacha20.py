"""ChaCha20 block function on torch tensors.

Counter-mode ChaCha20 in the original djb layout: 16 32-bit words per
state — [0:4) "expand 32-byte k" constants, [4:12) key, [12:14) 64-bit
block counter, [14:16) nonce. Words are held in int64 tensors; every add
and rotate is masked back to 32 bits, so the keystream equals the
reference's uint32 one bit for bit.
"""

import torch

CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
M32 = 0xFFFFFFFF

_QUARTER_ROUNDS = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & M32


def block(state_cols):
    """state_cols: 16 int64 tensors of 32-bit words (one per state word).
    Returns the 16 keystream words."""
    x = list(state_cols)
    for _ in range(10):
        for a, b, c, d in _QUARTER_ROUNDS:
            x[a] = (x[a] + x[b]) & M32
            x[d] = _rotl(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & M32
            x[b] = _rotl(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & M32
            x[d] = _rotl(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & M32
            x[b] = _rotl(x[b] ^ x[c], 7)
    return [(xi + si) & M32 for xi, si in zip(x, state_cols)]


def keystream(key, nonce, counters):
    """Keystream blocks for int64 block counters of any shape.

    key: 8 words, nonce: 2 words (Python ints). Returns int64 [..., 16].
    """
    def full(v):
        return torch.full_like(counters, v)

    cols = ([full(c) for c in CHACHA_CONSTANTS]
            + [full(int(k)) for k in key]
            + [counters & M32, (counters >> 32) & M32]
            + [full(int(n)) for n in nonce])
    return torch.stack(block(cols), dim=-1)
