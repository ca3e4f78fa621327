"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, reduced

from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.qwen15_110b import CONFIG as _qwen110b
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.moonshot_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _gemma3, _qwen110b, _stablelm, _minitron, _xlstm,
        _musicgen, _moonshot, _arctic, _zamba2, _qwen2vl,
    ]
}

ALIASES = {
    "gemma3-12b": "gemma3-12b",
    "qwen1.5-110b": "qwen1.5-110b",
    "qwen15-110b": "qwen1.5-110b",
    "stablelm-3b": "stablelm-3b",
    "minitron-8b": "minitron-8b",
    "xlstm-125m": "xlstm-125m",
    "musicgen-medium": "musicgen-medium",
    "moonshot-v1-16b-a3b": "moonshot-v1-16b-a3b",
    "moonshot-16b-a3b": "moonshot-v1-16b-a3b",
    "arctic-480b": "arctic-480b",
    "zamba2-7b": "zamba2-7b",
    "qwen2-vl-2b": "qwen2-vl-2b",
}


def get_config(arch: str) -> ModelConfig:
    key = ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config", "reduced"]
