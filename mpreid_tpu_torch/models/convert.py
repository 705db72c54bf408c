"""Weights carried into the port: JAX variable trees and reference ``.pth`` files.

ref mpreid_tpu/models/convert.py::export_reid_state_dict, ::load_param.

``from_jax_variables`` turns the JAX package's ``{"params", "batch_stats"}``
tree of a ReID model (as numpy arrays) into the port's state_dict, which is
the reference torch layout: it folds LoRA adapters into in_proj, undoes the
head-major column order of ``hm_native`` storage, transposes Dense kernels
to (out, in), reorders the patchify kernel (p, p, 3, w) → (w, 3, p, p), and
maps LayerNorm/BN ``scale`` → ``weight`` and ``mean``/``var`` →
``running_*``. ``load_param`` reads a reference ``.pth`` (``module.``
prefix stripped), or the weights of a training checkpoint of the port
(utils/checkpoint.py), into a model with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .clip_model import CLIPConfig

_REID_KEYS = ("visual", "bottleneck", "bottleneck_proj", "classifier",
              "classifier_proj", "cv_embed")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sub, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(sub["kernel"]).T.contiguous()
    if "bias" in sub:
        out[f"{prefix}.bias"] = _t(sub["bias"])


def _norm(sub, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(sub["scale"])
    out[f"{prefix}.bias"] = _t(sub["bias"])


def _block(sub, prefix: str, out: Dict[str, torch.Tensor], lora_alpha: float,
           inv_perm) -> None:
    attn = sub["attn"]
    in_kernel = np.asarray(attn["in_proj_kernel"], np.float32)
    in_bias = np.asarray(attn["in_proj_bias"], np.float32)
    if "lora_a" in attn:
        # fold ΔW = (α/r)·A·B in the stored layout, before un-permuting
        a = np.asarray(attn["lora_a"], np.float32)
        bmat = np.asarray(attn["lora_b"], np.float32)
        in_kernel = in_kernel + (lora_alpha / a.shape[1]) * (a @ bmat)
    if inv_perm is not None:
        in_kernel = in_kernel[:, inv_perm]
        in_bias = in_bias[inv_perm]
    out[f"{prefix}.attn.in_proj_weight"] = _t(in_kernel).T.contiguous()
    out[f"{prefix}.attn.in_proj_bias"] = _t(in_bias)
    out[f"{prefix}.attn.out_proj.weight"] = _t(attn["out_proj_kernel"]).T.contiguous()
    out[f"{prefix}.attn.out_proj.bias"] = _t(attn["out_proj_bias"])
    _norm(sub["ln_1"], f"{prefix}.ln_1", out)
    _norm(sub["ln_2"], f"{prefix}.ln_2", out)
    _dense(sub["mlp"]["c_fc"], f"{prefix}.mlp.c_fc", out)
    _dense(sub["mlp"]["c_proj"], f"{prefix}.mlp.c_proj", out)


def _bn(params, stats, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    _norm(params, prefix, out)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def from_jax_variables(variables: Dict[str, Any], clip_config: CLIPConfig
                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's ReID variable tree → the port's (reference) state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    unknown = sorted(set(params) - set(_REID_KEYS))
    if unknown:
        raise ValueError(f"not a baseline ReID variable tree; unported keys {unknown}")
    if not clip_config.is_vit or clip_config.use_moe:
        raise NotImplementedError("only the dense ViT tower is ported (ROADMAP.md, A7/A8)")
    out: Dict[str, torch.Tensor] = {}
    vp = params["visual"]
    pre = "image_encoder"
    out[f"{pre}.conv1.weight"] = _t(
        np.transpose(np.asarray(vp["conv1"]["kernel"], np.float32), (3, 2, 0, 1))
    )
    out[f"{pre}.class_embedding"] = _t(vp["class_embedding"])
    out[f"{pre}.positional_embedding"] = _t(vp["positional_embedding"])
    _norm(vp["ln_pre"], f"{pre}.ln_pre", out)
    inv_perm = clip_config.jax_perm_inverse("vision")
    for i in range(clip_config.vision_layers):
        _block(vp[f"resblocks_{i}"], f"{pre}.transformer.resblocks.{i}", out,
               clip_config.lora_alpha, inv_perm)
    _norm(vp["ln_post"], f"{pre}.ln_post", out)
    out[f"{pre}.proj"] = _t(vp["proj"])
    for name in ("bottleneck", "bottleneck_proj"):
        _bn(params[name], stats[name], name, out)
    for name in ("classifier", "classifier_proj"):
        out[f"{name}.weight"] = _t(params[name]["kernel"]).T.contiguous()
    if "cv_embed" in params:
        out["cv_embed"] = _t(params["cv_embed"])
    return out


def strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_param(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference-layout ``.pth`` into ``model`` (ref make_model.py:118-122),
    strictly: every key must match."""
    from mpreid_tpu_torch.utils.checkpoint import is_checkpoint

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if is_checkpoint(sd):
        sd = sd["model"]
    model.load_state_dict(strip_module(sd), strict=True)
    return model
