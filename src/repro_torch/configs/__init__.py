"""Architecture registry: ``--arch <id>`` -> (``CONFIG``, ``SMOKE``), and the
environment-knob registry of the PyTorch port (``configs/env.py``).

Arch modules import the model substrate, while low layers (``core``,
``kernels``) import ``env``; so the arch modules load lazily (PEP 562) and
``from ..configs import env`` never drags the model stack in.

``ARCHS`` lists all ten of the reference's archs; ``SHAPES``,
``ShapeSpec``, ``applicable`` and ``input_specs`` (``configs/shapes.py``,
the dry-run's inputs) load on first access too.
"""

_ARCH_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-0.6b": "qwen3_0_6b",
    "phi3-medium-14b": "phi3_medium_14b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "arctic-480b": "arctic_480b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-130m": "mamba2_130m",
}


class _LazyArchs(dict):
    """ARCHS mapping that imports each arch module on first access."""

    def __missing__(self, arch):
        import importlib

        if arch not in _ARCH_MODULES:
            raise KeyError(arch)
        mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __name__)
        self[arch] = mod
        return mod

    def __contains__(self, arch):
        return arch in _ARCH_MODULES

    def __iter__(self):
        return iter(_ARCH_MODULES)

    def __len__(self):
        return len(_ARCH_MODULES)

    def keys(self):
        return _ARCH_MODULES.keys()

    def items(self):
        return ((a, self[a]) for a in _ARCH_MODULES)

    def values(self):
        return (self[a] for a in _ARCH_MODULES)


ARCHS = _LazyArchs()

_SHAPE_EXPORTS = ("SHAPES", "ShapeSpec", "applicable", "input_specs")


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.SMOKE if smoke else mod.CONFIG


def __getattr__(name):
    if name in _SHAPE_EXPORTS:
        from . import shapes

        return getattr(shapes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ARCHS", "get_config", "SHAPES", "ShapeSpec", "applicable", "input_specs"]
