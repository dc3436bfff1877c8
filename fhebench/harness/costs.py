"""The table of peaks and the cost of a modular product, frozen.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full power limit of 700 W): 3.35 TB/s of HBM; 67 TFLOP/s of float32
outside the tensor cores, of which the 32-bit integer multiply-adds are
half the lanes, 67e12 / 4 a second (derived at the boost clock, never
measured); 1,979 TOP/s of int8 on the tensor cores. A 64-bit modular
product in 32-bit multiplies: a 64 x 64 high half takes 4 wide partial
products, a low half 3.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 67e12 / 4
INT8_OPS_PER_S = 1.979e15
SHOUP_MULS = 4 + 3 + 3      # mulhi(x, wp), x*w, hi*q
BARRETT_MULS = 4 + 3        # mulhi(x, bp), hi*q
MONT_MULS = 4 + 3 + 4       # a*b (128 bit), m = lo*k, m*q (128 bit)


def bound(bytes_moved, int32_muls, int8_macs=0):
    """(seconds, what bounds it): the larger of the bytes over the memory
    rate, the 32-bit multiplies over the INT32 rate and the int8
    operations (two a multiply-accumulate) over the int8 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(int32_muls / INT32_MULS_PER_S,
                2 * int8_macs / INT8_OPS_PER_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def recombine_muls(d, mont_rec=False):
    """32-bit multiplies of one digit recombination at d digits: the
    Barrett reduction of the low part, a Shoup product of the high part;
    with ``mont_rec`` a Montgomery product of each part."""
    if mont_rec:
        return MONT_MULS * (1 + (d > 5))
    return BARRETT_MULS + (SHOUP_MULS if d > 5 else 0)


def mxu_table_bytes(d, S, R, N):
    """Bytes of one channel's tables for one tensor-core transform: the
    two int8 stage tables, their int32 row sums, the int64 twiddles."""
    return d * d * (S * S + R * R) + 4 * d * (S + R) + 8 * N
