"""Synthetic collections for the port's tests and smoke run, and the LM batch
loader (``data.loader``)."""
