"""The share of the traced sub-window in which no operation ran on the card
(the union of the profiler's device operations)."""

from fhebench.harness.readers import idle_pct as read  # noqa: F401
