"""Optimizers as functions on the parameter tree (``optimizers``)."""
