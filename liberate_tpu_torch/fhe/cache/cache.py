"""Parameter cache management (reference: src/liberate/fhe/cache/cache.py).

Generated parameter sets (primes, contexts) are pickled under a per-user
cache directory. ``generate_cache`` pre-computes the standard prime grids.
"""

import glob
import os
from pathlib import Path

# Default cache location: keep out of the package tree so installs can be
# read-only; override with the LIBERATE_TPU_TORCH_CACHE environment
# variable. The folder is the port's own, so the JAX package and the port
# never read each other's pickles.
path_cache = os.environ.get(
    "LIBERATE_TPU_TORCH_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "liberate_tpu_torch"),
)


def ensure_cache(path=None) -> str:
    p = path or path_cache
    Path(p).mkdir(parents=True, exist_ok=True)
    return p


def clean_cache(path=None):
    p = path or path_cache
    for file in glob.glob(os.path.join(p, "*.pkl")):
        try:
            os.unlink(file)
        except OSError:
            pass


def generate_cache(path=None):
    """Pre-generate the standard prime caches (slow; done once)."""
    from ..context import generate_primes

    p = ensure_cache(path)
    generate_primes.generate_message_primes(cache_folder=p)
    generate_primes.generate_scale_primes(cache_folder=p)
    return p
