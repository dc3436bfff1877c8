"""64-bit word arithmetic on torch.int64 tensors.

A residue is one int64 word holding the unsigned 64-bit pattern (values
< 2^62 are non-negative; Shoup quotients and offset operands may have
bit 63 set and then read as negative int64). Addition, subtraction and
the low half of a product wrap modulo 2^64 exactly like the CUDA
``unsigned long long`` arithmetic the kernels use.

Three traps of int64 tensors, handled here once:

- ``>>`` on int64 is an arithmetic shift. The Montgomery core relies on
  that (signed inputs, as in the CUDA kernels' int64 code); every
  *unsigned* shift masks afterwards.
- ``<`` is a signed compare. ``lt_unsigned`` XORs bit 63 into both
  operands first; each caller keeps the signedness the reference uses.
- The high half of a 64 x 64 product has no torch op. ``mulhi64`` builds
  it from 32-bit limbs, splitting one factor of every limb product into
  16-bit halves so that no partial product overflows int64.

The Montgomery multiply and reduce are the reference's 31-bit half-limb
formulation (R = 2^62; the CUDA library's ntt_cuda_kernel.cu:12-59,
560-607), written as int64 ops: for every input they give the same lazy
[0, 2q) representative.
"""

import torch

HALF_NBITS = 31
NBITS = 62
LB_MASK = (1 << HALF_NBITS) - 1
FB_MASK = (1 << NBITS) - 1
M16 = 0xFFFF
M32 = 0xFFFFFFFF
INT64_MIN = -(1 << 63)


def to_signed(v: int) -> int:
    """An unsigned 64-bit Python int -> the int64 holding the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def tensor(vals, device=None) -> torch.Tensor:
    """Python ints (any size < 2^64, taken as unsigned) -> int64 tensor."""
    return torch.tensor([to_signed(int(v)) for v in vals], dtype=torch.int64,
                        device=device)


# -- compares -------------------------------------------------------------------


def lt_signed(a, b):
    return a < b


def lt_unsigned(a, b):
    """Unsigned 64-bit a < b on int64 bit patterns."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


# -- wide products --------------------------------------------------------------


def _mul32_wide(a, b):
    """Exact product of two values < 2^32 as (lo32, hi32), with no
    partial product above 2^48."""
    bl = b & M16
    bh = b >> 16
    p0 = a * bl
    p1 = a * bh
    lo = (p0 & M32) + ((p1 & M16) << 16)
    hi = (p0 >> 32) + (p1 >> 16) + (lo >> 32)
    return lo & M32, hi


def mulhi64(a, b):
    """Upper 64 bits of the exact unsigned 64 x 64 product."""
    a0 = a & M32
    a1 = (a >> 32) & M32
    b0 = b & M32
    b1 = (b >> 32) & M32
    ll_lo, ll_hi = _mul32_wide(a0, b0)
    lh_lo, lh_hi = _mul32_wide(a0, b1)
    hl_lo, hl_hi = _mul32_wide(a1, b0)
    hh_lo, hh_hi = _mul32_wide(a1, b1)
    mid = ll_hi + lh_lo + hl_lo                   # < 3 * 2^32
    hi = hh_lo + lh_hi + hl_hi + (mid >> 32)      # < 2^34
    return hi + (hh_hi << 32)                     # wraps to the u64 bits


def shoup_mul(x, w, wp, q):
    """w*x mod q as a [0, 2q) representative, for ANY 64-bit x, with
    Shoup's precomputed quotient wp = floor(w * 2^64 / q)."""
    return x * w - mulhi64(x, wp) * q


def barrett_2q(x, bp, q):
    """x mod q as a [0, 2q) representative for ANY 64-bit x, with the
    reciprocal bp = floor(2^64 / q) (shoup_mul with w = 1)."""
    return x - mulhi64(x, bp) * q


def shoup_quotient(x, q):
    """Elementwise floor(x * 2^64 / q) for 0 <= x < q < 2^63, by 64-step
    binary long division (unsigned compares: the shifted remainder may
    pass 2^63). Used once per table, never on the hot path."""
    x, q = torch.broadcast_tensors(x, q)
    r = x.clone()
    w = torch.zeros_like(r)
    for _ in range(64):
        r = r << 1
        ge = ~lt_unsigned(r, q)
        r = torch.where(ge, r - q, r)
        w = (w << 1) | ge.to(torch.int64)
    return w


# -- Montgomery core (31-bit half limbs; constants broadcast against data) ------


def montmul(a, b, ql, qh, kl, kh):
    """a*b*R^-1 mod q, lazy in [0, 2q), R = 2^62.

    ``a`` may be any two's-complement int64 (the arithmetic shift gives
    the CUDA int64 semantics for wrapped-negative inputs); ``b`` is a
    non-negative constant < 2^62. ql/qh/kl/kh are the 31-bit half limbs of
    q and k = -q^-1 mod R.
    """
    al = a & LB_MASK
    ah = a >> HALF_NBITS
    bl = b & LB_MASK
    bh = b >> HALF_NBITS

    alpha = ah * bh
    beta = ah * bl + al * bh
    gamma = al * bl

    gammal = gamma & LB_MASK
    gammah = gamma >> HALF_NBITS
    betal = beta & LB_MASK
    betah = beta >> HALF_NBITS

    upper = gammal * kh + (gammah + betal) * kl
    s = ((upper << HALF_NBITS) + gammal * kl) & FB_MASK

    sl = s & LB_MASK
    sh = s >> HALF_NBITS
    sqb = sh * ql + sl * qh
    sqbl = sqb & LB_MASK
    sqbh = sqb >> HALF_NBITS

    carry = (gamma + sl * ql) >> HALF_NBITS
    carry = (carry + betal + sqbl) >> HALF_NBITS
    return alpha + betah + sqbh + carry + sh * qh


# On int64 words the arithmetic shift already gives the signed semantics,
# so the signed variants are the same functions; the names follow the
# reference's unsigned/signed pair.
montmul_signed = montmul


def montredc(a, ql, qh, kl, kh):
    """a*R^-1 mod q for any two's-complement int64 ``a``."""
    xl = a & LB_MASK
    xh = a >> HALF_NBITS
    xkb = xh * kl + xl * kh
    s = ((xkb << HALF_NBITS) + xl * kl) & FB_MASK

    sl = s & LB_MASK
    sh = s >> HALF_NBITS
    sqb = sh * ql + sl * qh
    sqbl = sqb & LB_MASK
    sqbh = sqb >> HALF_NBITS
    carry = (a + sl * ql) >> HALF_NBITS
    carry = (carry + sqbl) >> HALF_NBITS
    return sqbh + carry + sh * qh


montredc_signed = montredc
