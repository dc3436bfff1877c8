"""As kernel_roofline.mult, in the dot cell."""

from fhebench.harness.readers import kernel_roofline_pct as read  # noqa: F401
