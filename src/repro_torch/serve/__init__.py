"""Serving stack of the port: row-wise table quantization and the recsys
inference engine."""
