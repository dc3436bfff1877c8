"""Counter-keyed CSPRNG.

A stream is (key, nonce, counter), and counters are a pure function of
(channel, block, step):

    counter(ch, j, step) = ch * L + j + step * inc,   inc = total_channels * L

so the same (key, channel, counter) gives the same words on any device and
on the host, and the port's draws equal the reference's word for word.
Channels: one stream per ordinary (scale+base) prime, ``num_repeating``
shared streams for special primes / errors / ternary secrets / CRS, and one
stream for encode-side random rounding. An explicit seed is honoured and
reproducible; with a seed and no nonce the nonce is derived from the seed.
"""

import hashlib
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ntt import u64
from .chacha20 import keystream
from .discrete_gaussian import build_CDT_binary_search_tree

M32 = 0xFFFFFFFF


def _samples(words):
    """[C, L, 16] keystream words -> (x_lo, x_hi) [C, 4L] 64-bit halves of
    each 128-bit sample: x_lo = (w0 << 32) | w1, x_hi = (w2 << 32) | w3."""
    C = words.shape[0]
    w = words.reshape(C, -1, 4)
    return ((w[..., 0] << 32) | w[..., 1], (w[..., 2] << 32) | w[..., 3])


def uniform_from_words(words, q, shift):
    """Unbiased range reduction floor(q * x / 2^128) + shift of the 128-bit
    samples x; q, shift: int64 [C] (q < 2^62). Returns int64 [C, N]."""
    x_lo, x_hi = _samples(words)
    qc = q[:, None]
    # q*x = q*x_hi*2^64 + q*x_lo: the top word is mulhi(q, x_hi) plus the
    # carry of mullo(q, x_hi) + mulhi(q, x_lo).
    lo1 = qc * x_hi
    s = lo1 + u64.mulhi64(qc, x_lo)
    carry = u64.lt_unsigned(s, lo1).to(torch.int64)
    return u64.mulhi64(qc, x_hi) + carry + shift[:, None]


def dg_from_words(words, btree, depth):
    """CDT binary-search-tree walk -> signed samples, int64 [C, N].

    btree: int64 [num_nodes, 2] (low64, high64 bit patterns). The sign is
    the lowest bit of x_hi, which then loses it (127-bit magnitude)."""
    x_low, x_high = _samples(words)
    sign = x_high & 1
    x_high = (x_high >> 1) & ((1 << 63) - 1)
    current = torch.zeros_like(x_low)
    counter, jump = 0, 1
    for _ in range(depth):
        node = btree[counter + current]
        y_low, y_high = node[..., 0], node[..., 1]
        ge = u64.lt_unsigned(y_high, x_high) | (
            (x_high == y_high) & ~u64.lt_unsigned(x_low, y_low))
        current = 2 * current + ge.to(torch.int64)
        counter += jump
        jump *= 2
    return torch.where(sign == 1, current, -current)


class Csprng:
    def __init__(self, num_coefs, num_channels, num_repeating_channels=2,
                 sigma=3.2, seed=None, nonce=None, device=None):
        """num_coefs: N. num_channels: number of ordinary-prime streams.
        num_repeating_channels: shared streams (errors/ternary/special/CRS).
        device: ``cuda:0`` unless the caller names another (see
        ``resolve_device``).
        """
        self.num_coefs = num_coefs
        self.num_channels = num_channels
        self.num_repeating_channels = num_repeating_channels
        self.sigma = sigma
        self.device = resolve_device(device)

        # 4 words per 128-bit sample -> L blocks per channel per draw.
        self.L = num_coefs // 4
        self.L_round = max(num_coefs // 16, 1)

        # Channel map: [0, C_ord) ordinary, then repeating, then randround.
        self.total_channels = num_channels + num_repeating_channels + 1
        self.randround_channel = self.total_channels - 1
        self.inc = self.total_channels * self.L

        btree, self.tree_depth = build_CDT_binary_search_tree(
            security_bits=128, sigma=sigma)
        self._btree = torch.from_numpy(btree.view(np.int64)).to(self.device)
        self.refresh(seed, nonce)

    def refresh(self, seed=None, nonce=None):
        """(Re)seed."""
        self.key = self._words_from_seed(seed, 8)
        if nonce is None and seed is not None:
            digest = hashlib.sha256(self.key.tobytes() + b"nonce").digest()
            nonce = np.frombuffer(digest[:8], dtype=np.uint32).copy()
        self.nonce = self._words_from_seed(nonce, 2)
        self.steps = np.zeros(self.total_channels, dtype=np.uint64)

    @staticmethod
    def _words_from_seed(seed, n_words):
        if seed is None:
            return np.frombuffer(os.urandom(4 * n_words),
                                 dtype=np.uint32).copy()
        if isinstance(seed, int):
            return np.array(
                [(seed >> (32 * i)) & M32 for i in range(n_words)],
                dtype=np.uint32)
        arr = np.asarray(seed, dtype=np.uint64).astype(np.uint32)
        if arr.size != n_words:
            raise ValueError(f"seed must provide {n_words} 32-bit words")
        return arr

    def _offsets(self, channels):
        """Starting 64-bit counters for the given channels; steps advance."""
        ch = np.asarray(channels, dtype=np.uint64)
        off = ch * np.uint64(self.L) + self.steps[ch] * np.uint64(self.inc)
        self.steps[ch] += np.uint64(1)
        return off

    def _draw_words(self, channels, nblocks=None, device=None):
        """Keystream int64 [C, nblocks, 16] of the channels' next step."""
        off = torch.from_numpy(self._offsets(channels).astype(np.int64))
        device = self.device if device is None else device
        j = torch.arange(nblocks or self.L, dtype=torch.int64, device=device)
        return keystream(self.key.tolist(), self.nonce.tolist(),
                         off.to(device)[:, None] + j)

    def _channel_plan(self, n_dedicated, repeats):
        """Last n_dedicated ordinary streams + the first ``repeats``
        repeating streams."""
        return (list(range(self.num_channels - n_dedicated,
                           self.num_channels))
                + list(range(self.num_channels,
                             self.num_channels + repeats)))

    # -- public draws ------------------------------------------------------------

    def randint(self, amax=3, shift=0, repeats=0):
        """Uniform ints in [shift, amax+shift) per channel; int64 [C, N].

        amax: int (one shared modulus) or a list of per-channel moduli.
        The trailing ``repeats`` channels use the repeating streams.
        """
        if not isinstance(amax, (list, tuple)):
            amax = [amax] * max(repeats, 1)
        words = self._draw_words(self._channel_plan(len(amax) - repeats,
                                                    repeats))
        return uniform_from_words(
            words, u64.tensor(amax, self.device),
            torch.full((len(amax),), shift, dtype=torch.int64,
                       device=self.device))

    def discrete_gaussian(self, non_repeats=0, repeats=1):
        """sigma=3.2 discrete Gaussian; signed int64 [C, N]."""
        words = self._draw_words(self._channel_plan(non_repeats, repeats))
        return dg_from_words(words, self._btree, self.tree_depth)

    def randround(self, coef):
        """Stochastic rounding of float64 coefficients, on the host.

        coef: float64 numpy [N]. Rounds |x| up with probability frac(|x|)
        using one 32-bit random word per coefficient. Returns int64 [N].
        """
        coef = np.asarray(coef, dtype=np.float64)
        words = self._draw_words([self.randround_channel], self.L_round,
                                 device="cpu").numpy().ravel()
        r = words[: coef.size].astype(np.uint64)

        sign = np.signbit(coef)
        a = np.abs(coef)
        integ = np.floor(a)
        frac = a - integ
        # Round-to-nearest-even of frac * 2^32, like CUDA __double2ll_rn.
        ifrac = np.rint(frac * float(1 << 32)).astype(np.uint64)
        rounded = (r < ifrac).astype(np.int64)
        return np.where(sign, -1, 1) * (integ.astype(np.int64) + rounded)
