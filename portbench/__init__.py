"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; everything a cell
needs is found by name from that file (see ``lib/spec.py``).
"""
