"""The harness's general parts: resolving a cell from ``BENCHMARK.json``,
the frozen traffic stream, parameter generation, the device and its peaks,
trace reduction, cost arithmetic, and the import guard."""
