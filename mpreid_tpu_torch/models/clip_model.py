"""CLIP architecture configuration and the tower factories.

ref mpreid_tpu/models/clip_model.py::CLIPConfig, ::VIT_B16, ::RN50,
::make_visual_tower, ::make_text_tower.

``vision_layout``/``text_layout`` name how the JAX package STORES its
in_proj columns ('' resolves to its default, "hm_native", which stores them
head-major). The port always stores and computes the torch [q|k|v] packing;
the fields matter only when a JAX variable tree is carried across
(models/convert.py::from_jax_variables).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from mpreid_tpu_torch.ops.attention import head_major_perm_inverse

from .text import TextTransformer
from .vit import VisionTransformer

# the JAX package's default storage layout for both towers
# (ref mpreid_tpu/ops/attention.py::MODEL_LAYOUT, ::TEXT_LAYOUT)
JAX_DEFAULT_LAYOUT = "hm_native"
JAX_LAYOUTS = ("packed", "hm", "hm_native")


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    # vision
    vision_layers: Any  # int (ViT) or tuple of 4 ints (ResNet)
    vision_width: int
    vision_patch_size: Optional[int]
    vision_stride_size: int
    h_resolution: int
    w_resolution: int
    # text
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int
    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_layers: int = 0
    dropout: float = 0.0
    shared_routing: bool = True
    # LoRA adapters on attention projections (0 = disabled)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # storage layouts of the JAX package's in_proj columns ('' → its default)
    vision_layout: str = ""
    text_layout: str = ""

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def use_moe(self) -> bool:
        return self.num_experts > 0 and self.top_k > 0

    def jax_perm_inverse(self, tower: str = "vision") -> Optional[np.ndarray]:
        """Column permutation from the JAX package's stored in_proj layout
        back to torch [q|k|v] (None when it already stores that packing)."""
        layout = (self.text_layout if tower == "text" else self.vision_layout) \
            or JAX_DEFAULT_LAYOUT
        if layout not in JAX_LAYOUTS:
            raise ValueError(f"unknown attention layout {layout!r}; expected one of {JAX_LAYOUTS}")
        if layout != "hm_native":
            return None
        if tower == "text":
            return head_major_perm_inverse(self.transformer_width, self.transformer_heads)
        return head_major_perm_inverse(self.vision_width, self.vision_width // 64)


VIT_B16 = CLIPConfig(
    embed_dim=512, vision_layers=12, vision_width=768, vision_patch_size=16,
    vision_stride_size=16, h_resolution=16, w_resolution=8,
    context_length=77, vocab_size=49408, transformer_width=512,
    transformer_heads=8, transformer_layers=12,
)

RN50 = CLIPConfig(
    embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64,
    vision_patch_size=None, vision_stride_size=16, h_resolution=16,
    w_resolution=8, context_length=77, vocab_size=49408,
    transformer_width=512, transformer_heads=8, transformer_layers=12,
)


def make_visual_tower(cfg: CLIPConfig, dtype: torch.dtype = torch.float32) -> VisionTransformer:
    if not cfg.is_vit:
        raise NotImplementedError("the RN50 backbone is not ported yet (ROADMAP.md, A8)")
    if cfg.use_moe:
        raise NotImplementedError("the MoE vision tower is not ported yet (ROADMAP.md, A7)")
    return VisionTransformer(
        h_resolution=cfg.h_resolution,
        w_resolution=cfg.w_resolution,
        patch_size=cfg.vision_patch_size,
        stride_size=cfg.vision_stride_size,
        width=cfg.vision_width,
        layers=cfg.vision_layers,
        heads=cfg.vision_width // 64,
        output_dim=cfg.embed_dim,
        dtype=dtype,
        lora_rank=cfg.lora_rank,
        lora_alpha=cfg.lora_alpha,
    )


def make_text_tower(cfg: CLIPConfig, dtype: torch.dtype = torch.float32) -> TextTransformer:
    return TextTransformer(
        context_length=cfg.context_length,
        vocab_size=cfg.vocab_size,
        width=cfg.transformer_width,
        heads=cfg.transformer_heads,
        layers=cfg.transformer_layers,
        embed_dim=cfg.embed_dim,
        dtype=dtype,
        lora_rank=cfg.lora_rank,
        lora_alpha=cfg.lora_alpha,
    )
