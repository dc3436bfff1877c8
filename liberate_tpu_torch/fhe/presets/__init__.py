from . import errors, types
from .params import params

__all__ = ["errors", "types", "params"]
