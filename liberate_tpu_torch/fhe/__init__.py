from . import presets
from .data_struct import DataStruct, data_struct
from .engine import CkksEngine, ckks_engine

__all__ = ["presets", "DataStruct", "data_struct", "CkksEngine",
           "ckks_engine"]
