"""CLIP architecture configuration, the tower factories and the CLIP file reader.

ref mpreid_tpu/models/clip_model.py::CLIPConfig, ::VIT_B16, ::RN50,
::make_visual_tower, ::make_text_tower, ::config_from_state_dict,
::load_torch_clip.

``load_torch_clip`` reads an OpenAI CLIP ``.pt`` (a TorchScript archive, or
else a plain state_dict) from a local path; nothing is downloaded. The port
stores the torch layout, so OpenAI's keys carry over one to one
(``visual.*`` → ``image_encoder.*``, the text keys → ``text_encoder.*``);
only the positional embeddings are resized to the model's grid (the ViT's,
and the RN50 attention pool's).

``vision_layout``/``text_layout`` name how the JAX package STORES its
in_proj columns ('' resolves to its default, "hm_native", which stores them
head-major). The port always stores and computes the torch [q|k|v] packing;
the fields matter only when a JAX variable tree is carried across
(models/convert.py::from_jax_variables).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from mpreid_tpu_torch.ops.attention import head_major_perm_inverse

from .resnet import ModifiedResNet
from .text import TextTransformer
from .vit import VisionTransformer, resize_pos_embed

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


def make_visual_tower(cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                      remat: bool = False) -> Union[VisionTransformer, ModifiedResNet]:
    """The visual tower of ``cfg``. ``remat`` (``TPU.REMAT``) rematerialises
    the ViT's blocks; the RN50 tower is built without it, as in the JAX
    package (ref clip_model.py:109-132)."""
    if not cfg.is_vit:
        return ModifiedResNet(
            layers=tuple(cfg.vision_layers),
            output_dim=cfg.embed_dim,
            heads=cfg.vision_width * 32 // 64,
            input_resolution=cfg.h_resolution * cfg.w_resolution,
            width=cfg.vision_width,
            dtype=dtype,
        )
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
        num_experts=cfg.num_experts if cfg.use_moe else 0,
        top_k=cfg.top_k,
        moe_layers=cfg.moe_layers,
        dropout=cfg.dropout,
        shared_routing=cfg.shared_routing,
        remat=remat,
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


# ---------------------------------------------------------------------------
# OpenAI CLIP files
# ---------------------------------------------------------------------------

# keys of an OpenAI archive that are not weights
_META_KEYS = ("input_resolution", "context_length", "vocab_size")
# the text tower's keys at the root of an OpenAI state_dict
_TEXT_ROOTS = ("token_embedding", "positional_embedding", "transformer", "ln_final",
               "text_projection")


def config_from_state_dict(sd: Dict[str, Any], h_resolution: int, w_resolution: int,
                           vision_stride_size: int) -> CLIPConfig:
    """The architecture of an OpenAI CLIP state_dict, from its shapes (ref
    ``config_from_state_dict``; the reference's model.py:678-702)."""
    vit = "visual.proj" in sd
    if vit:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    else:
        vision_layers = tuple(len({k.split(".")[2] for k in sd
                                   if k.startswith(f"visual.layer{b}")}) for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        vision_patch_size = None
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        vision_stride_size=vision_stride_size,
        h_resolution=h_resolution,
        w_resolution=w_resolution,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )


def read_clip_file(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of an OpenAI CLIP file on the CPU: a TorchScript
    archive's, or else (``torch.jit.load`` raises ``RuntimeError`` on a plain
    file) the pickled state_dict; the archive's meta entries dropped and
    every floating tensor cast to fp32 (OpenAI's archives hold fp16)."""
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items() if k not in _META_KEYS}


def _port_key(key: str) -> Optional[str]:
    if key.startswith("visual."):
        return "image_encoder." + key[len("visual."):]
    if key.split(".")[0] in _TEXT_ROOTS:
        return "text_encoder." + key
    return None  # logit_scale: the models have none (the JAX graft drops it too)


def load_torch_clip(path: str, h_resolution: int, w_resolution: int, vision_stride_size: int
                    ) -> Tuple[CLIPConfig, Dict[str, torch.Tensor]]:
    """An OpenAI CLIP ``.pt`` from disk → (its config at the given grid, the
    towers' weights under the port's names, fp32, positional embeddings
    resized to ``h_resolution`` × ``w_resolution``). ref ``load_torch_clip``
    (the reference's make_model.py:137-150 less the download)."""
    sd = read_clip_file(path)
    cfg = config_from_state_dict(sd, h_resolution, w_resolution, vision_stride_size)
    grid = ("visual.positional_embedding" if cfg.is_vit
            else "visual.attnpool.positional_embedding")
    sd[grid] = resize_pos_embed(sd[grid], h_resolution, w_resolution)
    return cfg, {_port_key(k): v for k, v in sd.items() if _port_key(k) is not None}
