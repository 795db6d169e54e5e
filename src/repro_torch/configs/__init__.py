"""Architecture registry: ``--arch <id>`` resolves here."""

from . import dlrm_criteo

ARCHS = {m.ARCH: m for m in (dlrm_criteo,)}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has: {sorted(ARCHS)}")
    return ARCHS[name]
