"""Shared neural-net layers of the port (the LM family's dense blocks)."""
