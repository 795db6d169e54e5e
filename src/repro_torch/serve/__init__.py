"""Serving stack of the port.

* ``serve.engine``   — the wave-batched LM engine: prefill, then KV-cache
  decode waves;
* ``serve.quantize`` — post-training row-wise int8 / bf16 table
  quantization;
* ``serve.cache``    — the deterministic hot-row embedding cache, on the
  host or in device slabs;
* ``serve.recsys``   — the microbatched quantized DLRM / DCN scoring
  engine.
"""

from .cache import CacheStats, DeviceHotRowCache, HotRowCache
from .engine import Request, ServeEngine
from .quantize import (dequantize_rows, dequantize_table, is_quantized_table, memory_report,
                       quantize_params, quantize_table, table_bytes)
from .recsys import RecRequest, RecsysEngine

__all__ = [
    "Request", "ServeEngine",
    "CacheStats", "HotRowCache", "DeviceHotRowCache",
    "quantize_table", "quantize_params", "dequantize_rows",
    "dequantize_table", "is_quantized_table", "table_bytes", "memory_report",
    "RecRequest", "RecsysEngine",
]
