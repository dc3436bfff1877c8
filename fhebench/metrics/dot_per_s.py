"""Rotate-and-sum dot-product requests completed in the window, over the
window's time."""

from fhebench.harness.readers import answers_per_s as read  # noqa: F401
