"""Carry keys and ciphertexts between the port and the JAX package.

The JAX package stores a polynomial as packed uint32 limbs [2, ..., C, N]
(low word, high word); the port as one int64 word tensor [..., C, N]. These
functions convert a DataStruct's tree of arrays in both directions through
numpy, without importing the JAX package.

A tree is a numpy array, a tuple or list of trees, or a nested DataStruct
given as a ``(tree, meta)`` pair; ``meta`` is a dict of the DataStruct's
metadata fields (include_special, ntt_state, montgomery_state, origin,
level, hash, version).
"""

import numpy as np
import torch

from .device import resolve_device
from .fhe.data_struct import DataStruct

_META = ("include_special", "ntt_state", "montgomery_state", "origin",
         "level", "hash", "version")


def limbs_to_int64(packed) -> np.ndarray:
    """packed uint32 [2, ...] -> int64 [...] (two's complement)."""
    packed = np.asarray(packed)
    lo = packed[0].astype(np.uint64)
    hi = packed[1].astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def int64_to_limbs(a) -> np.ndarray:
    """int64 [...] -> packed uint32 [2, ...]."""
    au = np.asarray(a, dtype=np.int64).view(np.uint64)
    return np.stack([(au & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (au >> np.uint64(32)).astype(np.uint32)])


def _is_nested(x):
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], dict)


def from_reference(tree, meta, device=None) -> DataStruct:
    """The port's DataStruct (int64 tensors on ``device``, ``cuda:0`` unless
    the caller names another) from a reference DataStruct's limb arrays and
    metadata."""
    device = resolve_device(device)

    def conv(x):
        if _is_nested(x):
            return from_reference(*x, device=device)
        if isinstance(x, (tuple, list)):
            return type(x)(conv(t) for t in x)
        return torch.from_numpy(limbs_to_int64(x).copy()).to(device)

    return DataStruct(conv(tree), **{k: meta[k] for k in _META if k in meta})


def to_reference_arrays(ds: DataStruct):
    """(tree, meta) of limb arrays for the reference DataStruct of ``ds``."""
    def conv(x):
        if isinstance(x, DataStruct):
            return to_reference_arrays(x)
        if isinstance(x, (tuple, list)):
            return type(x)(conv(t) for t in x)
        return int64_to_limbs(x.detach().to("cpu").numpy())

    return conv(ds.data), {k: getattr(ds, k) for k in _META}
