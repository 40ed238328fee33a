"""Evaluation of a codec over a dataset (``harness.evaluate``)."""
