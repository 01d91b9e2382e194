"""Optimiser (reference: ``repro.optim``)."""
