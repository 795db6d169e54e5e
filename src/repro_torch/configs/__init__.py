"""Architecture registry: ``--arch <id>`` resolves here."""

from . import (arctic_480b, dcn_criteo, deepseek_v2_236b, dlrm_criteo, granite_8b, mamba2_370m,
               qwen3_14b, tinyllama_1_1b, yi_34b, zamba2_1_2b)

ARCHS = {m.ARCH: m for m in (tinyllama_1_1b, qwen3_14b, yi_34b, granite_8b, arctic_480b,
                             deepseek_v2_236b, mamba2_370m, zamba2_1_2b, dlrm_criteo,
                             dcn_criteo)}

# the JAX package's other LM archs: their encoder-decoder and VLM blocks
# wait for ROADMAP item 18b-iii
LM_ARCHS_LATER = ("seamless-m4t-large-v2", "llava-next-34b")


def get_arch(name: str):
    if name in LM_ARCHS_LATER:
        raise KeyError(f"{name!r} is not ported yet: the LM family's encoder-decoder and VLM "
                       f"archs wait for ROADMAP item 18b-iii (the port has: {sorted(ARCHS)})")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has: {sorted(ARCHS)}")
    return ARCHS[name]
