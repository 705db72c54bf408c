"""Baseline CLIP-ReID model: CLIP visual tower + dual BNNeck + classifiers.

ref mpreid_tpu/models/reid.py::ReIDModel (``_sie``, ``backbone_features``,
``forward_train``, ``forward_eval``).

* feature dims: ViT-B/16 → (768 tokens, 512 proj); RN50 → (2048, 1024),
  the spatial means of the layer3/layer4 maps and the attention pool's
  mean token,
* SIE camera/view embedding added to the class token, scaled by ``sie_coe``,
* two BNNecks and two bias-free classifiers, or two margin heads under
  ``MODEL.COS_LAYER`` (the train logits then take the labels),
* train forward → ``{"scores": [cls_score, cls_score_proj],
  "feats": [feat_last, feat, feat_proj]}``: BNNecks in train mode (batch
  statistics, running statistics updated), fp32 logits on the BN features,
  ``feat_last`` the class token after L-1 blocks (before ``ln_post``; the
  MoE tower's after all L), plus ``router_logits`` from the MoE tower,
* eval forward → the 1280-d (ViT-B/16) or 3072-d (RN50) concat of
  post-BN (``neck_feat='after'``) or pre-BN (``'before'``) features, in the
  compute dtype. ``train=True`` reaches the RN50 tower's BatchNorms in the
  train forward only; eval and the Uni-Prompt image features use their
  running statistics.

Parameter names follow the reference state_dict (``image_encoder.*``,
``bottleneck{,_proj}.*``, ``classifier{,_proj}.weight``, ``cv_embed``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .clip_model import CLIPConfig, make_visual_tower
from .layers import BNNeck, classifier_scores, make_classifier
from .resnet import spatial_mean


class ReIDModel(nn.Module):
    def __init__(self, clip_config: CLIPConfig, num_classes: int, camera_num: int = 0,
                 view_num: int = 0, sie_camera: bool = False, sie_view: bool = False,
                 sie_coe: float = 3.0, neck_feat: str = "after", cos_layer: str = "",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.clip_config = clip_config
        self.camera_num = camera_num
        self.view_num = view_num
        self.sie_camera = sie_camera
        self.sie_view = sie_view
        self.sie_coe = sie_coe
        self.neck_feat = neck_feat
        self.dtype = dtype
        self.in_planes = clip_config.vision_width * (1 if clip_config.is_vit else 32)
        self.in_planes_proj = clip_config.embed_dim
        self.image_encoder = make_visual_tower(clip_config, dtype)
        self.bottleneck = BNNeck(self.in_planes)
        self.bottleneck_proj = BNNeck(self.in_planes_proj)
        self.classifier = make_classifier(num_classes, self.in_planes, cos_layer)
        self.classifier_proj = make_classifier(num_classes, self.in_planes_proj, cos_layer)
        if sie_camera and sie_view:
            n_embed = camera_num * view_num
        elif sie_camera:
            n_embed = camera_num
        elif sie_view:
            n_embed = view_num
        else:
            n_embed = 0
        self.cv_embed = nn.Parameter(torch.empty(n_embed, self.in_planes)) if n_embed else None

    def init_(self, gen: torch.Generator) -> None:
        """Seeded random init (distributions of the JAX package's inits)."""
        self.image_encoder.init_(gen)
        self.classifier.init_(gen, std=0.001)
        self.classifier_proj.init_(gen, std=0.001)
        if self.cv_embed is not None:
            with torch.no_grad():
                self.cv_embed.normal_(0.0, 0.02, generator=gen).clamp_(-0.04, 0.04)

    def _sie(self, cam_label, view_label) -> Optional[torch.Tensor]:
        """SIE lookup (ref make_model.py:88-96)."""
        if self.sie_camera and self.sie_view:
            if cam_label is None or view_label is None:
                raise ValueError("SIE camera+view needs both camera and view labels")
            idx = cam_label * self.view_num + view_label
        elif self.sie_camera:
            if cam_label is None:
                return None
            idx = cam_label
        elif self.sie_view:
            if view_label is None:
                return None
            idx = view_label
        else:
            return None
        return self.sie_coe * self.cv_embed[idx.long()]

    def backbone_features(self, x, cam_label=None, view_label=None, train: bool = False,
                          gen: Optional[torch.Generator] = None):
        """→ (feat_last, feat, feat_proj, raw_proj_tokens, router_logits):
        class-token (ViT) or pooled (RN50) vectors; the RN50 tokens are
        (L, B, out); the MoE tower's (n_gating, N, E) router logits or None.
        ``gen`` draws the MoE experts' dropout in training."""
        cv = self._sie(cam_label, view_label)
        if self.clip_config.is_vit:
            x11, x12, xproj, router_logits = self.image_encoder(x, cv, train=train, gen=gen)
            return x11[:, 0], x12[:, 0], xproj[:, 0], xproj, router_logits
        x3, x4, xproj = self.image_encoder(x, cv, train=train)
        return spatial_mean(x3), spatial_mean(x4), xproj[0], xproj, None

    def token(self, xproj: torch.Tensor, i: int) -> torch.Tensor:
        """Projected token ``i`` of every image: (B, L, out) for the ViT,
        (L, B, out) for RN50."""
        return xproj[:, i] if self.clip_config.is_vit else xproj[i]

    def forward_train(self, x, label=None, cam_label=None, view_label=None,
                      gen: Optional[torch.Generator] = None) -> dict:
        """``label`` reaches the margin heads (``MODEL.COS_LAYER``) only; the
        plain classifiers ignore it. The MoE tower adds ``router_logits``."""
        return self._forward_train(x, label, cam_label, view_label, gen)[0]

    def _forward_train(self, x, label, cam_label, view_label, gen) -> tuple:
        """→ (the train outputs, the raw projected tokens)."""
        feat_last, feat, feat_proj, raw_proj, router_logits = self.backbone_features(
            x, cam_label, view_label, train=True, gen=gen)
        feat_bn = self.bottleneck(feat, train=True)
        feat_proj_bn = self.bottleneck_proj(feat_proj, train=True)
        out = {
            "scores": [classifier_scores(self.classifier, feat_bn, label),
                       classifier_scores(self.classifier_proj, feat_proj_bn, label)],
            "feats": [feat_last, feat, feat_proj],
        }
        if router_logits is not None:
            out["router_logits"] = router_logits
        return out, raw_proj

    def forward_eval(self, x, cam_label=None, view_label=None) -> torch.Tensor:
        _, feat, feat_proj, _, _ = self.backbone_features(x, cam_label, view_label)
        if self.neck_feat == "after":
            return torch.cat([self.bottleneck(feat), self.bottleneck_proj(feat_proj)], dim=1)
        return torch.cat([feat, feat_proj], dim=1)

    def forward(self, x, cam_label=None, view_label=None) -> torch.Tensor:
        return self.forward_eval(x, cam_label, view_label)
