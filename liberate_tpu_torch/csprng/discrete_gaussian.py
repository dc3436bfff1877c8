"""Discrete Gaussian sampling via 128-bit CDT inversion.

Builds the cumulative distribution table for sigma=3.2 over the half plane
with tau = 2^ceil(log2(6*sigma)) sampling points, at 128-bit precision
(mpmath, 256-bit intermediate precision). Sampling walks the CDT as a 1-D
expanded binary search tree in constant time (depth steps); the sign comes
from one reserved random bit. Each sample consumes 128 random bits.
"""

import math

import mpmath as mpm
import numpy as np


def build_CDT_binary_search_tree(security_bits=128, sigma=3.2):
    """Returns (btree, tree_depth). btree: uint64 [num_nodes, 2] — the
    (low64, high64) halves of each node's 128-bit CDT value, in the
    layer-by-layer order of the tree walk."""
    mpm.mp.prec = security_bits * 2

    sampling_power = math.ceil(math.log2(6 * sigma))
    num_sampling_points = 2 ** sampling_power

    # Gaussian weights over the half plane at 256-bit working precision:
    # P(x) ∝ exp(-x²/2σ²)/(σ√2π), with the x=0 weight halved (it is
    # shared between the two half planes). The running sums are then
    # fixed-point scaled to 2^security_bits integers.
    sig = mpm.mpf(str(sigma))
    two = mpm.mpf("2")
    norm = sig * mpm.sqrt(two * mpm.pi)
    weights = [mpm.exp(-mpm.mpf(str(x)) ** 2 / (two * sig ** 2)) / norm
               for x in range(num_sampling_points)]
    weights[0] /= 2

    cdf = [mpm.mpf(0)]
    for wt in weights:
        cdf.append(cdf[-1] + wt)
    scale = two ** mpm.mpf(str(security_bits))
    CDT = [int(c * scale) for c in cdf]

    # Expanded binary tree over the CDT (layer by layer; node k of layer d
    # indexes CDT entry (2k+1) * tau / 2^(d+1)).
    tree_depth = sampling_power
    order = []
    for depth in range(tree_depth):
        num_nodes = 2 ** depth
        step = num_sampling_points // num_nodes
        first = step // 2
        order += list(range(first, num_sampling_points, step))

    mask64 = (1 << 64) - 1
    lo64 = np.array([CDT[i] & mask64 for i in order], dtype=np.uint64)
    hi64 = np.array([CDT[i] >> 64 for i in order], dtype=np.uint64)
    return np.stack([lo64, hi64], axis=1), tree_depth
