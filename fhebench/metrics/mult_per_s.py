"""Homomorphic multiplies (with relinearisation and rescale) completed in
the window, over the window's time: the first request's call to the last
one's answers on the card."""

from fhebench.harness.readers import answers_per_s as read  # noqa: F401
