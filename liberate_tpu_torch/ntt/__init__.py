from . import cuda_ntt, ops, u64
from .ntt_context import LevelPack, NttContext, PartPlan
from .rns_partition import RnsPartition, rns_partition

__all__ = [
    "cuda_ntt", "ops", "u64",
    "NttContext", "LevelPack", "PartPlan",
    "RnsPartition", "rns_partition",
]
