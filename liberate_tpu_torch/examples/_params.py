"""The examples' command line and parameters."""

import argparse

from .. import params

# The configuration the examples run without a preset: small enough for the
# CPU.
SMALL = dict(logN=10, scale_bits=30, num_scales=6, num_special_primes=2,
             is_secured=False, seed=1)


def parse_args(argv, doc):
    """``[preset] [--device DEVICE]`` from argv (default: the command
    line)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("preset", nargs="?", choices=sorted(params),
                    help="a preset (default: a small configuration, logN "
                         f"{SMALL['logN']})")
    ap.add_argument("--device", help="cpu, or a CUDA device (default "
                                     "cuda:0)")
    return ap.parse_args(argv)


def example_params(preset=None):
    """The engine parameters of a preset, else the small configuration."""
    if preset is None:
        return dict(SMALL)
    p = dict(params[preset])
    p.pop("mesh_shape", None)
    return p
