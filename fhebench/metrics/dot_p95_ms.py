"""The 95th percentile over all the window's dot requests of one request's
latency, from its first call to the synchronize that ends it."""

from fhebench.harness.readers import request_p95_ms as read  # noqa: F401
