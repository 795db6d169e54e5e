"""Architecture registry: ``--arch <id>`` resolves here."""

from . import (arctic_480b, dcn_criteo, deepseek_v2_236b, dlrm_criteo, granite_8b, llava_next_34b,
               mamba2_370m, qwen3_14b, seamless_m4t_large_v2, tinyllama_1_1b, yi_34b, zamba2_1_2b)

# the reference's order (src/repro/configs/__init__.py)
ARCHS = {m.ARCH: m for m in (qwen3_14b, tinyllama_1_1b, yi_34b, granite_8b, llava_next_34b,
                             zamba2_1_2b, mamba2_370m, seamless_m4t_large_v2, arctic_480b,
                             deepseek_v2_236b, dlrm_criteo, dcn_criteo)}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
