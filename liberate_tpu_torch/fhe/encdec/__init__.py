from .encdec import decode, encode

__all__ = ["encode", "decode"]
