"""Device time of PyTorch's own kernels and copies (the pointwise chains of
ntt/ops.py and ntt/u64.py) in the traced sub-window, per multiply."""

from fhebench.harness.readers import chains_ms_per_answer as read  # noqa: F401
