"""Benchmarks of the port: the paper's §5 tables (``paper_tables``), the
kernel bench (``kernels_bench``) and their harness (``run``)."""
