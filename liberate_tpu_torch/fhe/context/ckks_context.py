"""CKKS parameter context.

Derives the complete RNS-CKKS parameter set from user inputs — primes,
Montgomery constants, and NTT twiddle banks — mirroring the reference's
derivations (reference: src/liberate/fhe/context/ckks_context.py:151-341)
while staying framework-agnostic (Python, NumPy and the native host math of
``native/hostmath.cpp``; device arrays are built later by NttContext).
Every native step has a pure-Python twin (``*_plain``); the twin of a whole
context is ``with native.plain(): CkksContext(...)``, field for field the
same.

Prime pack layout (reference: ckks_context.py:237-260):
    q = [scale_0 .. scale_{L-1}, base_prime, special_0 .. special_{k-1}]
Rescaling consumes scale primes from index 0 upward (level l drops q[l-1]);
key switching uses the trailing special primes.
"""

import hashlib
import math
import pickle
import warnings
from pathlib import Path

import numpy as np

from ... import native
from ..cache import cache
from ..presets import errors
from .generate_primes import (
    descending_primes,
    generate_alternating_prime_sequence,
)
from .security_parameters import maximum_qbits

__all__ = [
    "CkksContext",
    "ckks_context",
    "primitive_root_2N",
    "primitive_root_2N_plain",
    "bit_reverse",
    "bit_reverse_order_index",
    "psi_bank",
    "psi_bank_plain",
]


def primitive_root_2N(q: int, N: int) -> int:
    """A primitive 2N-th root of unity mod q (q = 1 mod 2N).

    Same search as the reference (reference: ckks_context.py:20-28): raise
    candidates to the (q-1)/2N power and keep the first whose N-th power is
    not 1 (i.e. order exactly 2N).
    """
    g = native.primitive_root_2N(q, N)
    return primitive_root_2N_plain(q, N) if g is None else g


def primitive_root_2N_plain(q: int, N: int) -> int:
    """``primitive_root_2N`` in Python integers."""
    _2N = 2 * N
    K = (q - 1) // _2N
    g = None
    for x in range(2, max(N, 3)):
        g = pow(x, K, q)
        if pow(g, N, q) != 1:
            break
    return g


def bit_reverse(a: int, nbits: int) -> int:
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (a & 1)
        a >>= 1
    return r


def bit_reverse_order_index(logN: int) -> np.ndarray:
    N = 2 ** logN
    return np.array([bit_reverse(i, logN) for i in range(N)], dtype=np.int64)


def psi_bank(q: list[int], logN: int):
    """Bit-reverse-ordered power tables of psi and psi^-1 per prime.

    psi[c][i] = psi_c ** bit_reverse(i, logN)  (mod q_c), psi_c of order 2N.
    The forward NTT stage for block count m uses entries [m : 2m) — the
    Longa-Naehrig twiddle layout the reference pre-paints
    (reference: ckks_context.py:48-56, 89-112).

    Returned as int64 numpy arrays [C, N] (values < 2^62 fit; the result
    is pickled in the context cache).
    """
    N = 2 ** logN
    roots = [primitive_root_2N(qi, N) for qi in q]
    iroots = [pow(r, -1, qi) for r, qi in zip(roots, q)]
    banks = native.psi_banks(q, roots, iroots, logN)
    if banks is None:
        return psi_bank_plain(q, logN)
    return tuple(b.view(np.int64) for b in banks)


def psi_bank_plain(q: list[int], logN: int):
    """``psi_bank`` in Python integers."""
    N = 2 ** logN
    roots = [primitive_root_2N_plain(qi, N) for qi in q]
    iroots = [pow(r, -1, qi) for r, qi in zip(roots, q)]

    brev = [bit_reverse(i, logN) for i in range(N)]
    psis = np.empty((len(q), N), dtype=np.int64)
    ipsis = np.empty((len(q), N), dtype=np.int64)
    for c, (qi, psi, ipsi) in enumerate(zip(q, roots, iroots)):
        series_f = [1] * N
        series_i = [1] * N
        acc = 1
        iacc = 1
        for i in range(1, N):
            acc = acc * psi % qi
            iacc = iacc * ipsi % qi
            series_f[i] = acc
            series_i[i] = iacc
        for i in range(N):
            psis[c, i] = series_f[brev[i]]
            ipsis[c, i] = series_i[brev[i]]
    return psis, ipsis


def _get_message_special_primes(message_bits: int, N: int, how_many: int) -> list[int]:
    """Descending NTT-friendly primes below 2^message_bits for this N."""
    return descending_primes(message_bits, 2 * N, how_many)


@errors.log_error
class CkksContext:
    def __init__(
        self,
        buffer_bit_length=62,
        scale_bits=40,
        logN=15,
        num_scales=None,
        num_special_primes=2,
        sigma=3.2,
        uniform_ternary_secret=True,
        cache_folder=None,
        security_bits=128,
        quantum="post_quantum",
        distribution="uniform",
        read_cache=True,
        save_cache=True,
        verbose=False,
        is_secured=True,
    ):
        # The reference offers 62-bit (int64) and 30-bit (int32) buffer
        # words (reference: ckks_context.py:154,213-216). Here the word
        # selects the PRIME SIZING exactly like the reference (30 -> 28-bit
        # message/special primes, scale_bits <= 26), while the compute
        # radix stays R = 2^62 (one int64 word per residue either way).
        if buffer_bit_length not in (30, 62):
            raise ValueError(
                "buffer_bit_length must be 62 or 30 (reference parity)."
            )
        if buffer_bit_length == 30 and scale_bits > 26:
            raise ValueError(
                "buffer_bit_length=30 requires scale_bits <= 26 "
                "(scale primes must sit below the 28-bit message primes)."
            )

        cache_folder = cache.ensure_cache(cache_folder)

        self.generation_string = (
            f"{buffer_bit_length}_{scale_bits}_{logN}_{num_scales}_"
            f"{num_special_primes}_{security_bits}_{quantum}_{distribution}"
        )
        self.is_secured = is_secured

        savepath = Path(cache_folder) / (self.generation_string + ".pkl")
        if savepath.exists() and read_cache:
            with savepath.open("rb") as f:
                self.__dict__.update(pickle.load(f))
            if verbose:
                print(f"Read cached context from {savepath}.")
            return

        self.buffer_bit_length = buffer_bit_length
        self.scale_bits = scale_bits
        self.logN = logN
        self.num_special_primes = num_special_primes
        self.cache_folder = cache_folder
        self.security_bits = security_bits
        self.quantum = quantum
        self.distribution = distribution
        self.sigma = sigma
        self.uniform_ternary_secret = uniform_ternary_secret
        self.secret_key_sampling_method = (
            "uniform ternary" if uniform_ternary_secret else "sparse ternary"
        )

        self.N = 2 ** logN
        # Message (base/special) primes sit just below 2^(W-2).
        self.message_bits = self.buffer_bit_length - 2

        message_special_primes = _get_message_special_primes(
            self.message_bits, self.N, how_many=1 + num_special_primes
        )

        how_many_scales = 64 if self.logN < 16 else 128
        scale_primes = generate_alternating_prime_sequence(
            sb=scale_bits, N=self.N, how_many=how_many_scales
        )

        self.max_qbits = int(
            maximum_qbits(self.N, security_bits, quantum, distribution)
        )
        base_special_primes = message_special_primes[: 1 + num_special_primes]

        try:
            if num_scales is None:
                base_special_bits = sum(math.log2(p) for p in base_special_primes)
                available_bits = self.max_qbits - base_special_bits
                num_scales = 0
                available_bits -= math.log2(scale_primes[num_scales])
                while available_bits > 0:
                    num_scales += 1
                    available_bits -= math.log2(scale_primes[num_scales])
            self.num_scales = num_scales
            self.q = scale_primes[:num_scales] + base_special_primes
        except IndexError:
            raise errors.NotEnoughPrimes(scale_bits=scale_bits, N=self.N)

        self.total_qbits = math.ceil(sum(math.log2(qi) for qi in self.q))
        if self.total_qbits > self.max_qbits:
            if self.is_secured:
                raise errors.ViolatedAllowedQbits(
                    scale_bits=scale_bits, N=self.N, num_scales=self.num_scales,
                    max_qbits=self.max_qbits, total_qbits=self.total_qbits,
                )
            warnings.warn(
                f"Security budget violated: max_qbits={self.max_qbits} < "
                f"total_qbits={self.total_qbits}."
            )

        self.generate_montgomery_parameters()
        self.generate_paints()

        if verbose:
            self.init_print()
        if save_cache:
            with savepath.open("wb") as f:
                pickle.dump(self.__dict__, f)

    # -- Montgomery constants (reference: ckks_context.py:294-315) ------------

    def generate_montgomery_parameters(self):
        # Compute radix: fixed at 2^62 regardless of the buffer word (see
        # __init__ — the word selects prime sizing, the kernels' limb REDC
        # is 62-bit either way).
        self.compute_radix_bits = 62
        self.R = 2 ** self.compute_radix_bits
        self.R_square = [self.R ** 2 % qi for qi in self.q]
        self.half_buffer_bit_length = self.compute_radix_bits // 2
        self.lower_bits_mask = (1 << self.half_buffer_bit_length) - 1
        self.full_bits_mask = (1 << self.compute_radix_bits) - 1

        self.q_double = [qi << 1 for qi in self.q]
        self.R_inv = [pow(self.R, -1, qi) for qi in self.q]
        # k satisfies q*k = -1 (mod R); i.e. k = -q^{-1} mod R.
        self.k = [
            (self.R * R_invi - 1) // qi for R_invi, qi in zip(self.R_inv, self.q)
        ]

        # 31-bit half-limb decompositions (the REDC kernel operates on these).
        self.q_lower_bits = [qi & self.lower_bits_mask for qi in self.q]
        self.q_higher_bits = [qi >> self.half_buffer_bit_length for qi in self.q]
        self.k_lower_bits = [ki & self.lower_bits_mask for ki in self.k]
        self.k_higher_bits = [ki >> self.half_buffer_bit_length for ki in self.k]

    # -- NTT twiddle banks ----------------------------------------------------

    def generate_paints(self):
        """Bit-reversed psi power banks; stages slice [m : 2m).

        No butterfly index tables are kept: the transforms address their
        pairs arithmetically, so only the twiddle banks are needed.
        """
        self.N_inv = [pow(self.N, -1, qi) for qi in self.q]
        self.psi, self.psi_inv = psi_bank(self.q, self.logN)

    # -- Misc -----------------------------------------------------------------

    @property
    def hash_material(self) -> str:
        qstr = ",".join(str(qi) for qi in self.q)
        return self.generation_string + "_" + qstr

    def engine_hash(self) -> str:
        return hashlib.sha256(self.hash_material.encode("utf-8")).hexdigest()

    def init_print(self):
        print(
            f"CkksContext: buffer_bit_length={self.buffer_bit_length}, "
            f"scale_bits={self.scale_bits}, logN={self.logN}, N={self.N}, "
            f"num_special_primes={self.num_special_primes}, "
            f"num_scales={self.num_scales}, "
            f"security_bits={self.security_bits}, quantum={self.quantum}, "
            f"distribution={self.distribution}, "
            f"total_qbits={self.total_qbits}/{self.max_qbits}, "
            f"secured={self.is_secured}\nRNS primes: {self.q}"
        )


# Reference-compatible alias.
ckks_context = CkksContext
