"""Criteo-format data description for the port."""
