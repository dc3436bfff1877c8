"""Host time in the engine's calls, from each call until it returns (before
the synchronize), per multiply: the benchmark's own span."""

from fhebench.harness.readers import host_ms_per_answer as read  # noqa: F401
