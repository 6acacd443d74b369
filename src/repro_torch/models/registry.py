"""Model factory and arch-config registry: a copy of
``repro/models/registry.py`` for the architectures ported so far."""

from __future__ import annotations

import importlib

from ..configs.base import ModelConfig

ARCH_IDS = [
    "kimi-k2-1t-a32b",
    "mixtral-8x22b",
    "phi3-medium-14b",
    "qwen3-32b",
    "yi-9b",
    "qwen1.5-32b",
    "llava-next-34b",
    "whisper-small",
    "xlstm-125m",
    "recurrentgemma-2b",
]

# configs copied from repro/configs so far: the dense and MoE decoders,
# the hybrid, the ssm and the audio family
PORTED_ARCH_IDS = ["kimi-k2-1t-a32b", "mixtral-8x22b", "phi3-medium-14b",
                   "qwen3-32b", "yi-9b", "qwen1.5-32b", "recurrentgemma-2b",
                   "xlstm-125m", "whisper-small"]
# the families DecoderLM serves; get_model also serves "hybrid"
# (RGLRUModel), "ssm" (XLSTMModel) and "audio" (EncDecLM)
DECODER_FAMILIES = ("dense", "moe")
# where ROADMAP.md says when the rest comes
NOT_PORTED = "is not ported yet (ROADMAP.md queue 1: the vlm family)"


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """Load ``repro_torch/configs/<arch>.py`` and return CONFIG (or
    smoke())."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(f"the config of {arch_id} {NOT_PORTED}; "
                                  f"ported: {PORTED_ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.smoke() if smoke else mod.CONFIG


def get_model(cfg: ModelConfig, run=None, *, device=None,
              kernel_backend: "str | None" = None):
    """The model of ``cfg``'s family on ``device`` (default ``cuda``);
    ``run`` (a ``RunConfig``) sets the decoder's ``remat``."""
    if cfg.family in DECODER_FAMILIES:
        from .transformer import DecoderLM
        return DecoderLM(cfg, run, device=device,
                         kernel_backend=kernel_backend)
    if cfg.family == "hybrid":
        from .rglru import RGLRUModel
        return RGLRUModel(cfg, device=device, kernel_backend=kernel_backend)
    if cfg.family == "ssm":
        from .xlstm import XLSTMModel
        return XLSTMModel(cfg, device=device, kernel_backend=kernel_backend)
    if cfg.family == "audio":
        from .encdec import EncDecLM
        return EncDecLM(cfg, run, device=device,
                        kernel_backend=kernel_backend)
    raise NotImplementedError(f"the model of family {cfg.family!r} "
                              f"{NOT_PORTED}")
