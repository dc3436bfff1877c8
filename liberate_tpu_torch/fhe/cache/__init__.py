from . import cache

__all__ = ["cache"]
