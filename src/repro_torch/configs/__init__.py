"""Architecture registry of the port: one module per architecture, the
reference's ten, each ``dataclasses.asdict``-equal to the reference's.
``get_config(name)`` returns the full ArchConfig; ``get_config(name,
smoke=True)`` the reduced same-family smoke variant.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "musicgen_large",
    "pixtral_12b",
    "xlstm_125m",
    "jamba_1_5_large_398b",
    "qwen3_32b",
    "stablelm_12b",
    "command_r_plus_104b",
    "minicpm_2b",
    "kimi_k2_1t_a32b",
    "dbrx_132b",
]

_ALIASES = {name.replace("_", "-"): name for name in ARCH_IDS}


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg: ArchConfig = mod.CONFIG
    return cfg.smoke() if smoke else cfg
