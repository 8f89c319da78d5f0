"""Architecture registry: ``--arch <id>`` resolution for all launchers."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, shapes_for, SHAPES_BY_NAME

# arch-id -> module path (one module per assigned architecture)
_MODULES = {
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "whisper-base": "repro_torch.configs.whisper_base",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).smoke_config()


def get_matrix_config(arch_id: str) -> ModelConfig:
    """Conformance-matrix tiny variant: smaller than smoke, sized so a
    full C/R torture cell (train + restore, or serve + re-slot) runs in
    seconds on CPU. Falls back to the smoke config for arch modules
    that haven't defined one."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    fn = getattr(mod, "matrix_config", None)
    return fn() if fn is not None else mod.smoke_config()


def resolve_config(arch: str) -> ModelConfig:
    """One resolver for every ``arch`` string a job can carry: a bare
    registry id gives the published config; an id with a ``-smoke`` or
    ``-matrix`` suffix gives that reduced variant; ``<id>-layers<N>``
    gives the published config at its full width cut to N layers (a run
    whose time or disk cannot take the whole depth). Checkpoint metadata
    stores these strings, so both the trainer and the serving engine
    must resolve them identically — this is the single place."""
    if arch in _MODULES:
        return get_config(arch)
    if arch.endswith("-smoke"):
        return get_smoke_config(arch.removesuffix("-smoke"))
    if arch.endswith("-matrix"):
        return get_matrix_config(arch.removesuffix("-matrix"))
    base, cut, depth = arch.rpartition("-layers")
    if cut and base in _MODULES and depth.isdigit() and int(depth) > 0:
        cfg = get_config(base)
        if int(depth) <= cfg.n_layers:
            return cfg.replace(n_layers=int(depth))
    raise KeyError(
        f"unknown arch {arch!r}; known: {sorted(_MODULES)} "
        "(optionally with a -smoke, -matrix or -layers<N> suffix, N at "
        "most the published depth)")


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def get_shape(shape_name: str) -> ShapeConfig:
    if shape_name in SHAPES_BY_NAME:
        return SHAPES_BY_NAME[shape_name]
    # dynamic keys for tests / custom runs: "<kind>_s<seq>_b<batch>"
    parts = shape_name.split("_")
    if len(parts) == 3 and parts[1].startswith("s") and parts[2].startswith("b"):
        return ShapeConfig(shape_name, int(parts[1][1:]), int(parts[2][1:]),
                           parts[0])
    raise KeyError(f"unknown shape {shape_name!r}")


def all_cells():
    """Every applicable (arch, shape) dry-run cell."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            yield arch, shape.name


def skipped_cells():
    """Cells excluded per DESIGN.md §7 (long_500k on full-attention archs)."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.sub_quadratic:
            yield arch, "long_500k"
