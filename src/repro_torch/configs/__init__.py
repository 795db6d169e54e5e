"""Architecture registry: ``--arch <id>`` resolves here."""

from . import dcn_criteo, dlrm_criteo, tinyllama_1_1b

ARCHS = {m.ARCH: m for m in (tinyllama_1_1b, dlrm_criteo, dcn_criteo)}

# the JAX package's other LM archs: their MoE, MLA, SSM, hybrid, encoder-
# decoder and VLM blocks wait for ROADMAP item 18b
LM_ARCHS_LATER = ("qwen3-14b", "yi-34b", "granite-8b", "llava-next-34b", "zamba2-1.2b",
                  "mamba2-370m", "seamless-m4t-large-v2", "arctic-480b", "deepseek-v2-236b")


def get_arch(name: str):
    if name in LM_ARCHS_LATER:
        raise KeyError(f"{name!r} is not ported yet: the LM family's other archs wait for "
                       f"ROADMAP item 18b (the port has: {sorted(ARCHS)})")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has: {sorted(ARCHS)}")
    return ARCHS[name]
