"""Model factory — the ``make_model`` and ``make_model_uniprompt`` entry points,
and OpenAI CLIP weights grafted into a model.

ref mpreid_tpu/models/factory.py::clip_config_from_cfg, ::make_model,
::make_model_uniprompt, ::init_variables, ::graft_clip_variables,
::load_pretrained, ::switch_to_moe.

The (h, w) token grid follows ref ``make_model.py:60-62``:
``h_res = (SIZE_TRAIN[0] - 16) // STRIDE[0] + 1`` (and likewise for w).
Weights start random from a ``torch.Generator`` seeded with
``SOLVER.SEED``; ``load_pretrained`` replaces the towers with OpenAI CLIP
weights from ``MODEL.PRETRAIN_PATH``, and ``models/convert.py::load_param``
overwrites everything from a reference ``.pth``. ``switch_to_moe`` upcycles a
dense model to its MoE variant (the Uni-Prompt pipeline, after stage 1b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mpreid_tpu_torch.utils.device import device_from_cfg

from .clip_model import RN50, VIT_B16, CLIPConfig, load_torch_clip
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
        remat=bool(cfg.TPU.REMAT),
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


def switch_to_moe(cfg, model: ReIDModel) -> ReIDModel:
    """The MoE variant of a trained dense model ("upcycling", ref
    ``switch_to_moe``): the model rebuilt with ``MODEL.MOE``'s experts, each
    expert of block i a copy of the dense block i's MLP, the gates zero (so
    every token ties and routes uniformly at step 0), everything else copied,
    LoRA adapters and BatchNorm statistics included, and the model's margin
    head (``cos_layer``) and ``remat`` kept. On the model's device,
    in eval mode. A no-op (the same model back) when ``MODEL.MOE.ENABLED`` is
    off or the model is MoE already."""
    moe = cfg.MODEL.MOE
    if not moe.ENABLED or model.clip_config.use_moe:
        return model
    clip = dataclasses.replace(
        model.clip_config,
        num_experts=moe.NUM_EXPERTS,
        top_k=moe.TOP_K,
        moe_layers=moe.MOE_LAYERS,
        dropout=moe.DROPOUT,
        shared_routing=moe.SHARED_ROUTING,
        lora_rank=cfg.SOLVER.LORA.LORA_R if cfg.SOLVER.LORA.ENABLED else 0,
        lora_alpha=float(cfg.SOLVER.LORA.LORA_ALPHA),
        vision_layout=cfg.MODEL.ATTN_LAYOUT_VISION,
        text_layout=cfg.MODEL.ATTN_LAYOUT_TEXT,
    )
    device = next(model.parameters()).device
    new = type(model)(clip, model.classifier.weight.shape[0], model.camera_num, model.view_num,
                      model.sie_camera, model.sie_view, model.sie_coe, model.neck_feat,
                      model.cos_layer, model.dtype, model.remat).to(device)
    old = model.state_dict()
    sd = {}
    for key, t in new.state_dict().items():
        if key in old:
            sd[key] = old[key]
        elif ".experts." in key:  # resblocks.{i}.experts.{m}.c_fc.weight ← resblocks.{i}.mlp.c_fc.weight
            block, leaf = key.split(".experts.")
            sd[key] = old[f"{block}.mlp.{leaf.split('.', 1)[1]}"]
        elif key.endswith(".gate.weight"):
            sd[key] = torch.zeros_like(t)
        else:
            raise KeyError(f"switch_to_moe: no source for {key}")
    new.load_state_dict(sd, strict=True)
    return new.eval()


def graft_clip_weights(model: torch.nn.Module, clip_sd: Dict[str, torch.Tensor]
                       ) -> torch.nn.Module:
    """Replace the CLIP towers of ``model`` with ``clip_sd`` (``load_torch_clip``'s
    second value), in place (ref ``graft_clip_variables``): the visual tower,
    BatchNorm running statistics included, and the text tower where the model
    has one. The BNNecks, classifiers, prompt learner and the rest keep their
    values. Every key of a replaced tower must be in the file with its shape,
    apart from BatchNorm's batch counters."""
    own = model.state_dict()
    towers = ["image_encoder"] + (["text_encoder"] if hasattr(model, "text_encoder") else [])
    for tower in towers:
        want = {k for k in own if k.split(".")[0] == tower}
        have = {k for k in clip_sd if k.split(".")[0] == tower}
        missing = sorted(k for k in want - have if not k.endswith("num_batches_tracked"))
        unexpected = sorted(have - want)
        if missing or unexpected:
            raise ValueError(f"the CLIP file does not fit the model's {tower}: missing "
                             f"{missing[:5]}, unexpected {unexpected[:5]}")
        with torch.no_grad():
            for key in sorted(want & have):
                if own[key].shape != clip_sd[key].shape:
                    raise ValueError(f"{key}: the CLIP file holds {tuple(clip_sd[key].shape)}, "
                                     f"the model {tuple(own[key].shape)}")
                own[key].copy_(clip_sd[key])
    return model


def pretrain_path(cfg) -> str:
    """``MODEL.PRETRAIN_PATH``, or '' when no CLIP weights are asked for.
    ``MODEL.PRETRAIN_AUTO`` alone raises: its only purpose is a download."""
    if cfg.MODEL.PRETRAIN_AUTO and not cfg.MODEL.PRETRAIN_PATH:
        raise NotImplementedError(
            "MODEL.PRETRAIN_AUTO downloads the OpenAI CLIP file, which the port does not do: "
            "give the local file as MODEL.PRETRAIN_PATH")
    return cfg.MODEL.PRETRAIN_PATH


# the fields of a CLIPConfig that a CLIP file fixes: the visual tower's, and
# the text tower's where the model has one
_VISION_ARCH = ("embed_dim", "vision_layers", "vision_width", "vision_patch_size")
_TEXT_ARCH = ("context_length", "vocab_size", "transformer_width", "transformer_heads",
              "transformer_layers")


def load_pretrained(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """OpenAI CLIP weights from ``MODEL.PRETRAIN_PATH`` grafted into ``model``
    in place, at the model's token grid (ref ``load_pretrained`` for an
    explicit path; nothing is downloaded). A file of another architecture
    than the model's is refused, naming the fields that differ."""
    path = pretrain_path(cfg)
    if not path:
        raise ValueError("no CLIP file: set MODEL.PRETRAIN_PATH")
    own = model.clip_config
    clip, clip_sd = load_torch_clip(path, own.h_resolution, own.w_resolution,
                                    own.vision_stride_size)
    fields = _VISION_ARCH + (_TEXT_ARCH if hasattr(model, "text_encoder") else ())
    differ = {f: (getattr(clip, f), getattr(own, f)) for f in fields
              if getattr(clip, f) != getattr(own, f)}
    if differ:
        raise ValueError(f"{path} holds another CLIP than the model's {cfg.MODEL.NAME} "
                         f"(field: (file, model)): {differ}")
    return graft_clip_weights(model, clip_sd)
