from .ckks_context import CkksContext, ckks_context

__all__ = ["CkksContext", "ckks_context"]
