"""Architecture registry: ``--arch <id>`` resolves here."""

from . import (arctic_480b, dcn_criteo, deepseek_v2_236b, dlrm_criteo, granite_8b, llava_next_34b,
               mamba2_370m, qwen3_14b, seamless_m4t_large_v2, tinyllama_1_1b, yi_34b, zamba2_1_2b)
from .common import SHAPES, ModelApi, Shape, lowerables

# the reference's order (src/repro/configs/__init__.py)
_MODULES = [qwen3_14b, tinyllama_1_1b, yi_34b, granite_8b, llava_next_34b, zamba2_1_2b,
            mamba2_370m, seamless_m4t_large_v2, arctic_480b, deepseek_v2_236b, dlrm_criteo,
            dcn_criteo]

ARCHS = {m.ARCH: m for m in _MODULES}
ASSIGNED = [m.ARCH for m in _MODULES[:10]]  # the 10 graded architectures

# long_500k needs sub-quadratic sequence mixing
LONG_OK = {"zamba2-1.2b", "mamba2-370m"}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cells():
    """All assigned (arch, shape) dry-run cells, with skips applied."""
    out = []
    for arch in ASSIGNED:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            out.append((arch, shape))
    return out
