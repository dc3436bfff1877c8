"""The 95th percentile over all the window's requests of one request's
latency: one mult_batched call, from its start to the synchronize that
ends it."""

from fhebench.harness.readers import request_p95_ms as read  # noqa: F401
