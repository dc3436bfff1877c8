"""The port's kernels against their bounds in the traced sub-window: the
summed bound of every recorded wrapper call (kernels/ formulas, published
H100 peaks) over the summed profiler time of the port's kernels. A kernel
with no formula adds its time and no bound."""

from fhebench.harness.readers import kernel_roofline_pct as read  # noqa: F401
