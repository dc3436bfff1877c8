"""Message <-> polynomial encoding for CKKS, on the host in float64.

The negacyclic embedding is a length-N FFT twisted by e^{-i*pi*n/N}
("twister"; the inverse uses the conjugate "skewer"), composed with a slot
permutation so that slot rotations become signed coefficient permutations
mu_p(n) = p*n mod 2N with p = 3^k. The FFT stays in numpy: its float64
rounding then matches the reference's bit for bit, so both packages encode
a message to the same integers.
"""

import numpy as np

# ---------------------------------------------------------------------------
# Slot permutations (reference: encdec.py:9-127).
# ---------------------------------------------------------------------------


def circular_shift_permutation(N, shift=1):
    """Half-wise circular shift: the lower N/2 slots roll forward by
    ``shift``, the upper half rolls backward by the same amount."""
    h = N // 2
    idx = np.arange(h)
    return np.concatenate([(idx - shift) % h, (idx + shift) % h + h])


def canon_permutation(N, k=1):
    """mu_p(n) = p*n mod 2N over n in [0, 2N), p = 2k+1 (odd, coprime to 2N)."""
    M = 2 * N
    p = int(2 * k + 1)
    return p * np.arange(M) % M


def canon_permutation_n(N, k=1):
    """mu_p over n in [0, N) (the ciphertext-side rotations)."""
    M = 2 * N
    p = int(2 * k + 1)
    return p * np.arange(N) % M


def fold_permutation(p):
    """Fold the FFT at Nyquist: keep odd entries, map (x-1)/2."""
    return (p[1::2] - 1) // 2


def permutation_cycles(perm):
    """Cycle decomposition. Each cycle is listed starting from the IMAGE
    of its smallest member and follows the map until it closes — the
    phase convention conjugate_permutation's elementwise alignment
    assumes on both of its operands."""
    remaining = dict(enumerate(int(x) for x in perm))
    cycles = []
    while remaining:
        cur = remaining[min(remaining)]
        cycle = []
        while cur in remaining:
            cycle.append(cur)
            cur = remaining.pop(cur)
        cycles.append(cycle)
    return cycles


def conjugate_permutation(p, q):
    """A permutation r carrying the orbit structure of q onto p (so
    r maps q-cycles to p-cycles elementwise, giving r∘q∘r⁻¹ = p): both
    are decomposed with the same phase convention and the k-th q-cycle
    is matched against the k-th p-cycle position by position."""
    p_cycles = permutation_cycles(p)
    q_cycles = permutation_cycles(q)
    assert [len(c) for c in p_cycles] == [len(c) for c in q_cycles], (
        "permutations with different cycle spectra have no conjugator"
    )
    r = np.zeros_like(np.asarray(p))
    for p_cyc, q_cyc in zip(p_cycles, q_cycles):
        r[q_cyc] = p_cyc
    return r


def inverse_permutation(p):
    return np.arange(len(p))[np.argsort(p)]


_perm_cache = {}


def prepost_perms(N):
    if N in _perm_cache:
        return _perm_cache[N]
    circ_shift = circular_shift_permutation(N)
    canon = canon_permutation(N)
    fold = fold_permutation(canon)
    post_perm = conjugate_permutation(circ_shift, fold)
    pre_perm = inverse_permutation(post_perm)[: N // 2]
    _perm_cache[N] = (pre_perm, post_perm)
    return pre_perm, post_perm


# ---------------------------------------------------------------------------
# Negacyclic FFT (host, float64).
# ---------------------------------------------------------------------------


def _twister(N):
    return np.exp(-1j * np.pi * np.arange(N) / N)


def _skewer(N):
    return np.exp(1j * np.pi * np.arange(N) / N)


def _fft(x, norm):
    return np.fft.fft(x, norm=norm)


def _ifft(x, norm):
    return np.fft.ifft(x, norm=norm)


def encode(m, rng=None, scale=2 ** 40, deviation=1.0, norm="forward",
           return_without_scaling=False):
    """Complex message (N/2 slots) -> integer polynomial coefficients (N).

    With ``return_without_scaling`` the raw float64 coefficients are
    returned (for the bias_guard path); otherwise coefficients are scaled
    and stochastically rounded with ``rng.randround``.
    """
    m = np.asarray(m)
    N = m.size * 2
    pre_perm, _ = prepost_perms(N)

    mm = np.zeros(N, dtype=np.complex128)
    mm[pre_perm] = m * deviation
    mm = mm + np.conj(mm[::-1])

    poly = (_fft(mm, norm) * _twister(N)).real
    if return_without_scaling:
        return poly
    return rng.randround(poly * np.float64(scale))


def decode(poly, scale=2 ** 40, correction=1.0, norm="forward",
           return_without_scaling=False):
    """Signed integer (or float) polynomial (N) -> complex message.

    Returns the full length-N complex vector; callers take [:N//2]
    (reference: ckks_engine.py:334-344).
    """
    poly = np.asarray(poly, dtype=np.float64)
    N = poly.size
    _, post_perm = prepost_perms(N)
    mm = _ifft(poly * _skewer(N), norm)
    if not return_without_scaling:
        mm = mm / scale * correction
    out = np.zeros_like(mm)
    out[post_perm] = mm
    return out


# ---------------------------------------------------------------------------
# Ciphertext-side rotation/conjugation permutations as gather tables
# (reference: encdec.py:171-197).
# ---------------------------------------------------------------------------

_rot_cache = {}


def _signed_perm_data(N, leap):
    """For mu_p with p = 2*leap+1: (gather_idx, neg_mask) such that
    out[j] = (-1)^neg_mask[j] * x[gather_idx[j]]."""
    key = (N, leap)
    if key in _rot_cache:
        return _rot_cache[key]
    perm = canon_permutation_n(N, leap)
    folded = perm % N           # destination index of source i
    sign_neg = (perm // N) % 2  # 1 if the sign flips
    gather = inverse_permutation(folded)
    neg_mask = sign_neg[gather].astype(bool)
    _rot_cache[key] = (gather.astype(np.int32), neg_mask)
    return _rot_cache[key]


def rotate_perm_data(N, delta):
    """Gather/sign tables for rotating slots by ``delta``."""
    shift = delta % N
    leap = (pow(3, shift, 2 * N) - 1) // 2 % (2 * N)
    return _signed_perm_data(N, leap)


def conjugate_perm_data(N):
    """Gather/sign tables for slot conjugation (mu_{-1}: leap = N-1)."""
    return _signed_perm_data(N, N - 1)
