"""Uni-Prompt ReID model: prompt learner + text encoder + the ReID head.

ref mpreid_tpu/models/uniprompt.py::prompt_template_tokens,
::view_to_platform_modality, ::PromptLearner, ::UniPromptReID.

* ``PromptLearner``: per-identity generic context (num_classes × 8 × ctx),
  modality context (2 × 4 × ctx) and platform context (2 × 4 × ctx),
  spliced into the embedded template ``"X " * 16 + "person."`` between the
  SOT prefix and the "person. EOT pad…" suffix. Stage ``'1a'`` zeroes the
  domain contexts; other stages select them from the view label by the MMMP
  camera layout (view ≥ 12 → UAV platform; 6 ≤ view < 12 or view == 13 →
  IR modality), or take their mean when no view is given.
* ``get_text``: the text tower over the assembled prompt, EOT-pooled by the
  template; ``get_image``, ``get_image_vp`` (the learned visual prompt added
  to the projected tokens), ``get_more_image``, ``get_image_update`` (MLP
  fusion of image and text features); ``forward_train`` adds
  ``img_feature_proj`` and the raw projected tokens to the baseline's
  outputs.

Parameter names follow the reference state_dict: ``prompt_learner.ctx_*``,
``prompt_learner.visual_enhanced_net.linear{1,2}`` (present in the
reference's parameters, never called by its forward), ``image_fusion_net.
fc{1,2}``, ``visual_prompt``, ``text_encoder.*`` and the baseline's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .clip_model import CLIPConfig, make_text_tower
from .layers import Linear, init_normal_
from .reid import ReIDModel
from .tokenizer import tokenize

N_GENERIC_CTX = 8
N_MODAL_CTX = 4
N_PLAT_CTX = 4
N_TOTAL_CTX = N_GENERIC_CTX + N_MODAL_CTX + N_PLAT_CTX
PROMPT_SUFFIX = "person."
FUSION_HIDDEN = 256


def prompt_template_tokens() -> np.ndarray:
    """The tokenized ``"X X ... X person."`` template, (1, 77) int32."""
    return tokenize(" ".join(["X"] * N_TOTAL_CTX) + f" {PROMPT_SUFFIX}")


def view_to_platform_modality(view: torch.Tensor):
    """MMMP camera layout → (platform, modality) indices."""
    plat = (view >= 12).long()
    modal = (((view >= 6) & (view < 12)) | (view == 13)).long()
    return plat, modal


class MLP2(nn.Module):
    """Two linear layers with a ReLU between, in the compute dtype (the
    ``visual_enhanced_net`` and ``image_fusion_net`` of the reference)."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int, names=("fc1", "fc2"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = names
        self.dtype = dtype
        self.add_module(names[0], Linear(dim_in, hidden))
        self.add_module(names[1], Linear(hidden, dim_out))

    def init_(self, gen: torch.Generator) -> None:
        for name in self.names:
            getattr(self, name).init_(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, second = (getattr(self, n) for n in self.names)
        return second(F.relu(first(x.to(self.dtype))))


class PromptLearner(nn.Module):
    """``feat_dim`` is the width of the features ``visual_enhanced`` takes
    (the CLIP embedding width, which the reference writes as 512, as it does
    ``ctx_dim``: the two coincide for ViT-B/16)."""

    def __init__(self, num_classes: int, ctx_dim: int, feat_dim: int,
                 dtype: torch.dtype = torch.float32, n_modalities: int = 2,
                 n_platforms: int = 2):
        super().__init__()
        self.ctx_dim = ctx_dim
        self.ctx_generic = nn.Parameter(torch.empty(num_classes, N_GENERIC_CTX, ctx_dim))
        self.ctx_modality = nn.Parameter(torch.empty(n_modalities, N_MODAL_CTX, ctx_dim))
        self.ctx_platform = nn.Parameter(torch.empty(n_platforms, N_PLAT_CTX, ctx_dim))
        self.visual_enhanced_net = MLP2(feat_dim, ctx_dim // 16, ctx_dim,
                                        names=("linear1", "linear2"), dtype=dtype)

    def init_(self, gen: torch.Generator) -> None:
        for p in (self.ctx_generic, self.ctx_modality, self.ctx_platform):
            init_normal_(p, 0.02, gen)
        self.visual_enhanced_net.init_(gen)

    def visual_enhanced(self, image_feature: torch.Tensor) -> torch.Tensor:
        return self.visual_enhanced_net(image_feature)

    def context(self, label: torch.Tensor, view: Optional[torch.Tensor], stage: str,
                ctx_generic: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (B, 16, ctx_dim) fp32 context block; ``ctx_generic`` stands in
        for the parameter of that name (the TTPT tuner's context)."""
        b = label.shape[0]
        generic = (self.ctx_generic if ctx_generic is None else ctx_generic)[label]
        if stage == "1a":
            modal = generic.new_zeros((b, N_MODAL_CTX, self.ctx_dim))
            plat = generic.new_zeros((b, N_PLAT_CTX, self.ctx_dim))
        elif view is not None:
            plat_idx, modal_idx = view_to_platform_modality(view)
            modal = self.ctx_modality[modal_idx]
            plat = self.ctx_platform[plat_idx]
        else:
            modal = self.ctx_modality.mean(dim=0, keepdim=True).expand(b, -1, -1)
            plat = self.ctx_platform.mean(dim=0, keepdim=True).expand(b, -1, -1)
        return torch.cat([generic, modal, plat], dim=1)


class UniPromptReID(ReIDModel):
    def __init__(self, clip_config: CLIPConfig, num_classes: int, camera_num: int = 0,
                 view_num: int = 0, sie_camera: bool = False, sie_view: bool = False,
                 sie_coe: float = 3.0, neck_feat: str = "after", cos_layer: str = "",
                 dtype: torch.dtype = torch.float32):
        super().__init__(clip_config, num_classes, camera_num, view_num, sie_camera, sie_view,
                         sie_coe, neck_feat, cos_layer, dtype)
        self.ctx_dim = clip_config.transformer_width
        self.text_encoder = make_text_tower(clip_config, dtype)
        self.prompt_learner = PromptLearner(num_classes, self.ctx_dim, self.in_planes_proj, dtype)
        self.visual_prompt = nn.Parameter(torch.empty(1, 1, self.in_planes_proj))
        self.image_fusion_net = MLP2(2 * self.in_planes_proj, FUSION_HIDDEN,
                                     self.in_planes_proj, dtype=dtype)
        self.register_buffer("tokenized_prompts",
                             torch.from_numpy(prompt_template_tokens()).long(), persistent=False)

    def init_(self, gen: torch.Generator) -> None:
        super().init_(gen)
        self.text_encoder.init_(gen)
        self.prompt_learner.init_(gen)
        init_normal_(self.visual_prompt, 0.02, gen)
        self.image_fusion_net.init_(gen)

    # ------------------------------------------------------------------ text
    def get_text(self, label: torch.Tensor, view: Optional[torch.Tensor] = None,
                 stage: str = "1a", ctx_generic: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Prompted text features (B, embed_dim) for identity labels, with
        ``ctx_generic`` in place of the prompt learner's when given."""
        ctx = self.prompt_learner.context(label, view, stage, ctx_generic)
        b = label.shape[0]
        embedding = self.text_encoder.embed(self.tokenized_prompts)  # (1, 77, ctx)
        prefix = embedding[:, :1].expand(b, -1, -1)
        suffix = embedding[:, 1 + N_TOTAL_CTX:].expand(b, -1, -1)
        prompts = torch.cat([prefix, ctx.to(prefix.dtype), suffix], dim=1)
        return self.text_encoder.encode_embeddings(prompts, self.tokenized_prompts)

    # ----------------------------------------------------------------- image
    def _projected(self, x: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(x)[2]

    def get_image(self, x: torch.Tensor) -> torch.Tensor:
        """Projected class-token (ViT) or mean-token (RN50) feature of the
        image encoder, BatchNorms on their running statistics."""
        return self.token(self._projected(x), 0)

    def get_image_vp(self, x: torch.Tensor) -> torch.Tensor:
        """``get_image`` with the learned visual prompt added."""
        xproj = self._projected(x)
        return self.token(xproj + self.visual_prompt.to(xproj.dtype), 0)

    def get_more_image(self, x: torch.Tensor):
        """Low, mid and high projected tokens."""
        xproj = self._projected(x)
        return self.token(xproj, 0), self.token(xproj, 1), self.token(xproj, -1)

    def get_image_update(self, image_feature: torch.Tensor, text_feature: torch.Tensor
                         ) -> torch.Tensor:
        """MLP fusion of image and text features."""
        return self.image_fusion_net(torch.cat([image_feature, text_feature], dim=-1))

    # ------------------------------------------------------------------ main
    def forward_train(self, x, label=None, cam_label=None, view_label=None,
                      gen: Optional[torch.Generator] = None) -> dict:
        """The baseline's train outputs (``router_logits`` included) plus
        ``img_feature_proj`` (the projected class or mean token) and
        ``image_features_proj_raw`` (all projected tokens, in the tower's own
        layout)."""
        out, raw_proj = self._forward_train(x, label, cam_label, view_label, gen)
        out["img_feature_proj"] = out["feats"][2]
        out["image_features_proj_raw"] = raw_proj
        return out
