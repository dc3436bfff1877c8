"""Typed exceptions and error-logging decorator.

Same taxonomy as the reference (reference: src/liberate/fhe/presets/errors.py:5-167),
re-expressed for this framework.
"""

import functools
import logging

logger = logging.getLogger("liberate_tpu_torch")


def log_error(func_or_class):
    """Decorator that logs exceptions raised by public API entry points.

    The reference applies it per-method throughout ckks_engine
    (reference: src/liberate/fhe/presets/errors.py:5-14); applied to a
    CLASS it wraps every public method in place, so ``@log_error`` on
    CkksEngine covers the whole API surface.
    """
    if isinstance(func_or_class, type):
        for name, attr in list(vars(func_or_class).items()):
            if callable(attr) and not name.startswith("_"):
                setattr(func_or_class, name, log_error(attr))
        return func_or_class

    @functools.wraps(func_or_class)
    def wrapper(*args, **kwargs):
        try:
            return func_or_class(*args, **kwargs)
        except Exception as e:
            logger.error("%s: %s", func_or_class.__qualname__, e)
            raise

    return wrapper


class LiberateTpuError(Exception):
    """Base class for all liberate_tpu_torch errors."""


class NotMatchType(LiberateTpuError):
    def __init__(self, origin=None, to=None):
        super().__init__(f"Data type mismatch: got '{origin}', expected '{to}'.")
        self.origin, self.to = origin, to


class NotMatchDataStructState(LiberateTpuError):
    def __init__(self, origin=None):
        super().__init__(
            f"Data struct '{origin}' is in the wrong NTT/Montgomery state."
        )
        self.origin = origin


class SecretKeyNotIncludeSpecialPrime(LiberateTpuError):
    def __init__(self):
        super().__init__(
            "The secret key does not include special primes; "
            "cannot build a key that requires them."
        )


class NotFoundMessageSpecialPrimes(LiberateTpuError):
    def __init__(self, message_bit=None, N=None):
        super().__init__(
            f"No cached message/special primes for message_bit={message_bit}, N={N}."
        )


class NotFoundScalePrimes(LiberateTpuError):
    def __init__(self, scale_bits=None, N=None):
        super().__init__(
            f"No cached scale primes for scale_bits={scale_bits}, N={N}."
        )


class NotEnoughPrimes(LiberateTpuError):
    def __init__(self, scale_bits=None, N=None):
        super().__init__(
            f"Not enough scale primes for scale_bits={scale_bits}, N={N}."
        )


class ViolatedAllowedQbits(LiberateTpuError):
    def __init__(self, scale_bits=None, N=None, num_scales=None,
                 max_qbits=None, total_qbits=None):
        super().__init__(
            f"Security budget violated: requested total_qbits={total_qbits} "
            f"exceeds max_qbits={max_qbits} "
            f"(scale_bits={scale_bits}, N={N}, num_scales={num_scales})."
        )


class MaximumLevelError(LiberateTpuError):
    def __init__(self, level=None, level_max=None):
        super().__init__(
            f"Cannot rescale past the maximum level: level={level}, "
            f"maximum={level_max}."
        )


class NotSameLevelError(LiberateTpuError):
    def __init__(self, a=None, b=None):
        super().__init__(
            f"Operand levels differ ({a} vs {b}); use auto_level / "
            f"level_up to align them first.")


class DifferentTypeError(LiberateTpuError):
    def __init__(self, a=None, b=None):
        super().__init__(f"Operands have incompatible types: '{a}' vs '{b}'.")


class HashMismatchError(LiberateTpuError):
    def __init__(self):
        super().__init__(
            "Engine hash mismatch: the data was produced by an engine with "
            "different parameters."
        )


class VersionMismatchError(LiberateTpuError):
    def __init__(self, got=None, expected=None):
        super().__init__(f"Serialization version mismatch: {got} != {expected}.")
