"""Architecture registry: one module per assigned arch, copied from the
JAX package's ``repro.configs`` (pure Python).  ``get_config(name)`` /
``list_archs()`` are the public API; :func:`.smoke.reduced` shrinks a
config for the CPU tests."""

from .base import ArchConfig, SHAPES, ShapeSpec, get_config, list_archs, shape_for

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        command_r_35b,
        grok1_314b,
        jamba15_large,
        minicpm3_4b,
        minicpm_2b,
        musicgen_medium,
        qwen2_moe_a2_7b,
        qwen2_vl_7b,
        rwkv6_7b,
        smollm_360m,
    )


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "shape_for"]
