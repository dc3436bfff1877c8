"""liberate_tpu_torch — the RNS-CKKS library on PyTorch and CUDA.

The port of ``liberate_tpu`` to one NVIDIA Hopper GPU: polynomials are
int64 tensors [C, N] of 62-bit words (Montgomery R = 2^62), the NTTs and
the key-switch multiply-accumulate are hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use), and everything between them
is plain PyTorch. Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``, where the kernels' plain twins run instead.
``parallel`` runs an engine as ranks that shard the RNS channel axis, and
the transforms sharded over the coefficient axis.
"""

from .version import VERSION
from .fhe.data_struct import DataStruct, data_struct
from .fhe.engine import CkksEngine, ckks_engine
from .fhe.presets import errors, params, types

__all__ = [
    "VERSION",
    "CkksEngine",
    "ckks_engine",
    "DataStruct",
    "data_struct",
    "params",
    "types",
    "errors",
]
