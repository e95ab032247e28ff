"""Synthetic collections for the port's tests and smoke run."""
