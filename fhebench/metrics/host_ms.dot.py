"""Host time in the engine's calls, from a request's first call until its
last returns (before the synchronize), per dot request."""

from fhebench.harness.readers import host_ms_per_answer as read  # noqa: F401
