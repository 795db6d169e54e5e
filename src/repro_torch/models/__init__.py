"""Recommendation models of the port."""
