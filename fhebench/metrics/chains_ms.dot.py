"""Device time of PyTorch's own kernels and copies in the traced sub-window,
per dot request."""

from fhebench.harness.readers import chains_ms_per_answer as read  # noqa: F401
