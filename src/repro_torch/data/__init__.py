"""Trajectory batches (reference: ``repro.data``)."""
