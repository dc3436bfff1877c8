"""As idle_pct.mult, in the dot cell."""

from fhebench.harness.readers import idle_pct as read  # noqa: F401
