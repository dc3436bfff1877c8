"""Plain CKKS decryption and decoding, in PyTorch on any device.

A ciphertext (c0, c1) at level l holds, for each ordinary prime q_i of the
level (q[l:num_scales + 1]), words [C, N] whose residues mod q_i satisfy
c0 + c1 s = pt (mod q_i, X^N + 1) for one small integer polynomial pt. The
judge works out pt mod every q_i, rebuilds pt from two of them (the
level's rescale prime q_l and the base prime), and checks every other
residue against it: a word altered in any channel shows. The message is
pt / q_l divided by the ciphertext's scale, read at the slots: slot j is
the polynomial's value at zeta^(3^-j), zeta = exp(i pi / N).

Scales, as the library keeps them: a fresh ciphertext at level 0 carries
the message at 2^(2 scale_bits); a multiply rescales both inputs by the
prime of their level and multiplies, one level down; rotations and
additions keep the scale.

Modular products of 62-bit words: the multiplier is cut into 16-bit limbs
and the quotient of each step is estimated in float64, where it is off by
at most one; int64 products wrap, and the remainder, which is small, is
exact all the same.
"""

import numpy as np
import torch

LIMB = 16
LIMBS = 4


def _fix(r, q):
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def _step(acc, a, limb, q):
    """(acc 2^16 + a limb) mod q for acc, a in [0, q), 0 <= limb < 2^16."""
    est = torch.floor((acc.double() * 65536.0 + a.double() * limb.double())
                      / q.double()).long()
    return _fix(acc * 65536 + a * limb - est * q, q)


def mulmod(a, b, q):
    """a b mod q for a, b in [0, q), q < 2^62 (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    acc = torch.zeros_like(a)
    for k in reversed(range(LIMBS)):
        acc = _step(acc, a, (b >> (LIMB * k)) & 0xFFFF, q)
    return acc


def negacyclic_ternary(x, s, q):
    """x s mod (q, X^N + 1) for words x [C, N] in [0, q) and a ternary s [N]:
    each 16-bit limb of x convolved with s in float64 (every sum below
    2^33, so it rounds exactly), then the limbs summed back mod q."""
    C, N = x.shape
    twist = torch.exp(1j * torch.pi * torch.arange(N, device=x.device,
                                                   dtype=torch.float64) / N)
    fs = torch.fft.fft(s.to(torch.float64) * twist)
    limbs = torch.stack([(x >> (LIMB * k)) & 0xFFFF for k in range(LIMBS)])
    conv = torch.fft.ifft(torch.fft.fft(limbs.to(torch.float64) * twist)
                          * fs) / twist
    conv = torch.round(conv.real).long()
    zero = torch.zeros_like(x)
    acc = zero
    for k in reversed(range(LIMBS)):
        acc = _fix(_step(acc, zero, zero, q) + torch.remainder(conv[k], q), q)
    return acc


def slot_values(y, scale):
    """The N/2 slots of a real polynomial y [N] (float64), over ``scale``."""
    N = y.shape[-1]
    n = torch.arange(N, device=y.device, dtype=torch.float64)
    ev = torch.fft.ifft(y * torch.exp(1j * torch.pi * n / N), norm="forward")
    g = pow(3, -1, 2 * N)
    e = np.empty(N // 2, dtype=np.int64)
    e[0] = 1
    for j in range(1, N // 2):
        e[j] = e[j - 1] * g % (2 * N)
    return ev[torch.from_numpy((e - 1) // 2).to(y.device)] / scale


class Judge:
    """Decrypts and decodes ciphertexts of one configuration and seed.

    q: the modulus chain; num_scales; scale_bits; s: the ternary secret."""

    def __init__(self, q, num_scales, scale_bits, s, device):
        self.q = [int(p) for p in q]
        self.num_scales = num_scales
        self.delta = 2.0 ** scale_bits
        self.device = device
        self.s = torch.as_tensor(s, dtype=torch.int64, device=device)

    def primes(self, level):
        return self.q[level:self.num_scales + 1]

    def scale(self, level, mults):
        """The message scale of a ciphertext at ``level`` reached from
        level ``level - mults`` by ``mults`` multiplies (0 or 1 here),
        after the final division by q_level."""
        if mults == 0:
            s = self.delta ** 2
        elif mults == 1:
            s = (self.delta ** 2 / self.q[level - 1]) ** 2
        else:
            raise ValueError("one multiply at most")
        return s / self.q[level]

    def residues(self, c0, c1, level):
        """pt mod each prime of the level [C, N]."""
        qs = torch.tensor(self.primes(level), dtype=torch.int64,
                          device=self.device)[:, None]
        c0 = torch.remainder(c0.to(self.device), qs)
        c1 = torch.remainder(c1.to(self.device), qs)
        return _fix(c0 + negacyclic_ternary(c1, self.s, qs), qs)

    def judge(self, ct_words, level, mults, expected):
        """(largest slot error, residues inconsistent with the rest) of a
        ciphertext's words (c0, c1) against the expected slots."""
        c0, c1 = ct_words
        primes = self.primes(level)
        if c0.shape != (len(primes), self.s.shape[0]) or c1.shape != c0.shape:
            return float("inf"), -1
        pt = self.residues(c0, c1, level)
        ql, qb = primes[0], primes[-1]
        dev = self.device
        rl = pt[0]
        rlc = torch.where(rl > ql // 2, rl - ql, rl)
        qb_t = torch.tensor(qb, dtype=torch.int64, device=dev)
        k = mulmod(torch.remainder(pt[-1] - rlc, qb_t),
                   torch.tensor(pow(ql, -1, qb), dtype=torch.int64,
                                device=dev), qb_t)
        k = torch.where(k > qb // 2, k - qb, k)
        # every residue of the rebuilt pt = rlc + ql k
        qs = torch.tensor(primes, dtype=torch.int64, device=dev)[:, None]
        ql_mod = torch.tensor([ql % p for p in primes], dtype=torch.int64,
                              device=dev)[:, None]
        rebuilt = _fix(mulmod(ql_mod, torch.remainder(k, qs), qs)
                       + torch.remainder(rlc, qs), qs)
        bad = int((rebuilt != pt).sum())
        y = k.double() + rlc.double() / ql
        slots = slot_values(y, self.scale(level, mults))
        exp = torch.as_tensor(expected, dtype=torch.complex128, device=dev)
        return float((slots - exp).abs().max()), bad
