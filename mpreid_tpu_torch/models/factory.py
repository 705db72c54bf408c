"""Model factory — the ``make_model`` and ``make_model_uniprompt`` entry points.

ref mpreid_tpu/models/factory.py::clip_config_from_cfg, ::make_model,
::make_model_uniprompt, ::init_variables.

The (h, w) token grid follows ref ``make_model.py:60-62``:
``h_res = (SIZE_TRAIN[0] - 16) // STRIDE[0] + 1`` (and likewise for w).
Weights start random from a ``torch.Generator`` seeded with
``SOLVER.SEED``; ``models/convert.py::load_param`` overwrites them from a
reference ``.pth``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mpreid_tpu_torch.utils.device import device_from_cfg

from .clip_model import CLIPConfig, RN50, VIT_B16
from .reid import ReIDModel
from .uniprompt import UniPromptReID

_BASE_CONFIGS = {"ViT-B-16": VIT_B16, "RN50": RN50}

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def clip_config_from_cfg(cfg) -> CLIPConfig:
    name = cfg.MODEL.NAME
    if name not in _BASE_CONFIGS:
        raise ValueError(f"Unknown MODEL.NAME {name!r}; expected one of {list(_BASE_CONFIGS)}")
    base = _BASE_CONFIGS[name]
    if cfg.MODEL.DEBUG_TINY and base.is_vit:
        base = dataclasses.replace(
            base, embed_dim=32, vision_layers=2, vision_width=64,
            transformer_width=64, transformer_heads=1, transformer_layers=2,
        )
    h_res = int((cfg.INPUT.SIZE_TRAIN[0] - 16) // cfg.MODEL.STRIDE_SIZE[0] + 1)
    w_res = int((cfg.INPUT.SIZE_TRAIN[1] - 16) // cfg.MODEL.STRIDE_SIZE[1] + 1)
    moe = cfg.MODEL.MOE
    return dataclasses.replace(
        base,
        h_resolution=h_res,
        w_resolution=w_res,
        vision_stride_size=cfg.MODEL.STRIDE_SIZE[0],
        num_experts=moe.NUM_EXPERTS if moe.ENABLED else 0,
        top_k=moe.TOP_K if moe.ENABLED else 0,
        moe_layers=moe.MOE_LAYERS if moe.ENABLED else 0,
        dropout=moe.DROPOUT,
        shared_routing=moe.SHARED_ROUTING,
        lora_rank=cfg.SOLVER.LORA.LORA_R if cfg.SOLVER.LORA.ENABLED else 0,
        lora_alpha=float(cfg.SOLVER.LORA.LORA_ALPHA),
        vision_layout=cfg.MODEL.ATTN_LAYOUT_VISION,
        text_layout=cfg.MODEL.ATTN_LAYOUT_TEXT,
    )


def compute_dtype(cfg) -> torch.dtype:
    name = cfg.TPU.COMPUTE_DTYPE
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"Unknown TPU.COMPUTE_DTYPE {name!r}; expected one of {list(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def _common_kwargs(cfg, num_class: int, camera_num: int, view_num: int) -> dict:
    return dict(
        clip_config=clip_config_from_cfg(cfg),
        num_classes=num_class,
        camera_num=camera_num,
        view_num=view_num,
        sie_camera=cfg.MODEL.SIE_CAMERA,
        sie_view=cfg.MODEL.SIE_VIEW,
        sie_coe=cfg.MODEL.SIE_COE,
        neck_feat=cfg.TEST.NECK_FEAT,
        cos_layer=cfg.MODEL.COS_LAYER_TYPE if cfg.MODEL.COS_LAYER else "",
        dtype=compute_dtype(cfg),
    )


def build_model(cfg, num_class: int, camera_num: int, view_num: int) -> ReIDModel:
    """The baseline CLIP-ReID model (ref make_model.py:131-133) on the CPU, with
    its parameters allocated but not initialised (for a state_dict to fill)."""
    return ReIDModel(**_common_kwargs(cfg, num_class, camera_num, view_num))


def build_model_uniprompt(cfg, num_class: int, camera_num: int, view_num: int
                          ) -> UniPromptReID:
    """The Uni-Prompt model (ref make_model_uniprompt.py:252-254) on the CPU,
    allocated but not initialised."""
    return UniPromptReID(**_common_kwargs(cfg, num_class, camera_num, view_num))


def _initialised(cfg, model, device) -> ReIDModel:
    device = device_from_cfg(cfg) if device is None else torch.device(device)
    model.init_(torch.Generator().manual_seed(int(cfg.SOLVER.SEED)))
    return model.to(device).eval()


def make_model(cfg, num_class: int, camera_num: int, view_num: int,
               device: Optional[torch.device] = None) -> ReIDModel:
    """``build_model``, randomly initialised from ``SOLVER.SEED``, in eval mode
    on ``device`` (by default the device ``MODEL.DEVICE`` names)."""
    return _initialised(cfg, build_model(cfg, num_class, camera_num, view_num), device)


def make_model_uniprompt(cfg, num_class: int, camera_num: int, view_num: int,
                         device: Optional[torch.device] = None) -> UniPromptReID:
    """``build_model_uniprompt``, randomly initialised from ``SOLVER.SEED``
    (the JAX package's init distributions), in eval mode on ``device``."""
    return _initialised(cfg, build_model_uniprompt(cfg, num_class, camera_num, view_num),
                        device)
