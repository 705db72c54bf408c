"""Weights carried into the port: JAX variable trees and reference ``.pth`` files.

ref mpreid_tpu/models/convert.py::export_reid_state_dict, ::load_param.

``from_jax_variables`` turns the JAX package's ``{"params", "batch_stats"}``
tree of a baseline ReID or a Uni-Prompt model (as numpy arrays) into the
port's state_dict, which is the reference torch layout: it undoes the
head-major column order of ``hm_native`` storage (per tower), transposes
Dense kernels to (out, in), reorders conv kernels (the patchify kernel and
the RN50 tower's) from flax's (kh, kw, in, out) to (out, in, kh, kw), maps
LayerNorm/BN ``scale`` → ``weight`` and ``mean``/``var`` → ``running_*``
(the RN50 BatchNorms' from ``batch_stats``), renames the RN50 blocks
(``layer1_0`` → ``layer1.0``, ``downsample_conv``/``downsample_bn`` →
``downsample.0``/``.1``), and renames the Uni-Prompt subtrees (``text`` →
``text_encoder``, ``fusion_fc*`` → ``image_fusion_net.fc*``,
``ve_linear*`` → ``prompt_learner.visual_enhanced_net.linear*``), and maps
an MoE block ``moe_resblocks_{i}`` to the reference's
``…resblocks.{i}.gate.weight`` and ``…experts.{m}.c_{fc,proj}.{weight,bias}``
(ref ``_export_vit_visual``; the layout ``_convert_vit_moe_trained`` reads,
and the one ``load_param`` reads strictly into an MoE model). LoRA
adapters are folded into in_proj (the reference layout, which has no
adapter keys), or carried as ``attn.lora_a``/``attn.lora_b`` for a port
model built with adapters (``keep_lora``). ``load_param`` reads a
reference ``.pth`` (``module.`` prefix stripped), or the weights of a
training checkpoint of the port (utils/checkpoint.py), into a model.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .clip_model import CLIPConfig

_REID_KEYS = ("visual", "bottleneck", "bottleneck_proj", "classifier",
              "classifier_proj", "cv_embed")
_UNIPROMPT_KEYS = ("text", "prompt_learner", "visual_prompt", "fusion_fc1", "fusion_fc2")
# keys of a reference Uni-Prompt state_dict that the port derives instead:
# the prompt learner's template embeddings (buffers the reference computes
# from the CLIP token embedding at init)
_DERIVED_KEYS = ("prompt_learner.token_prefix", "prompt_learner.token_suffix")
# the text tower's token embedding, which a reference Uni-Prompt state_dict
# does not hold (the JAX load_param overlay leaves it as initialised too)
_TOKEN_EMBEDDING = "text_encoder.token_embedding.weight"


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
           inv_perm, keep_lora: bool) -> None:
    attn = sub["attn"]
    in_kernel = np.asarray(attn["in_proj_kernel"], np.float32)
    in_bias = np.asarray(attn["in_proj_bias"], np.float32)
    if "lora_a" in attn:
        a = np.asarray(attn["lora_a"], np.float32)
        bmat = np.asarray(attn["lora_b"], np.float32)
        if keep_lora:
            # lora_b's columns are stored in in_proj's order: un-permute alike
            out[f"{prefix}.attn.lora_a"] = _t(a)
            out[f"{prefix}.attn.lora_b"] = _t(bmat if inv_perm is None else bmat[:, inv_perm])
        else:
            # fold ΔW = (α/r)·A·B in the stored layout, before un-permuting
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
    if "mlp" in sub:
        _dense(sub["mlp"]["c_fc"], f"{prefix}.mlp.c_fc", out)
        _dense(sub["mlp"]["c_proj"], f"{prefix}.mlp.c_proj", out)
        return
    # an MoE block (ref convert.py::_export_vit_visual): the gate and each expert
    out[f"{prefix}.gate.weight"] = _t(sub["gate_kernel"]).T.contiguous()
    experts = sub["experts"]
    for m in range(np.shape(experts["c_fc_kernel"])[0]):
        for name in ("c_fc", "c_proj"):
            _dense({"kernel": experts[f"{name}_kernel"][m], "bias": experts[f"{name}_bias"][m]},
                   f"{prefix}.experts.{m}.{name}", out)


def _bn(params, stats, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    _norm(params, prefix, out)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _text(tp, clip_config: CLIPConfig, out: Dict[str, torch.Tensor], keep_lora: bool) -> None:
    pre = "text_encoder"
    out[f"{pre}.token_embedding.weight"] = _t(tp["token_embedding"]["embedding"])
    out[f"{pre}.positional_embedding"] = _t(tp["positional_embedding"])
    inv_perm = clip_config.jax_perm_inverse("text")
    for i in range(clip_config.transformer_layers):
        _block(tp[f"resblocks_{i}"], f"{pre}.transformer.resblocks.{i}", out,
               clip_config.lora_alpha, inv_perm, keep_lora)
    _norm(tp["ln_final"], f"{pre}.ln_final", out)
    out[f"{pre}.text_projection"] = _t(tp["text_projection"])


def _conv(sub, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(sub["kernel"], np.float32), (3, 2, 0, 1)))


def _vit(vp, clip_config: CLIPConfig, out: Dict[str, torch.Tensor], keep_lora: bool) -> None:
    pre = "image_encoder"
    _conv(vp["conv1"], f"{pre}.conv1", out)
    out[f"{pre}.class_embedding"] = _t(vp["class_embedding"])
    out[f"{pre}.positional_embedding"] = _t(vp["positional_embedding"])
    _norm(vp["ln_pre"], f"{pre}.ln_pre", out)
    inv_perm = clip_config.jax_perm_inverse("vision")
    for i in range(clip_config.vision_layers):
        _block(vp.get(f"moe_resblocks_{i}") or vp[f"resblocks_{i}"],
               f"{pre}.transformer.resblocks.{i}", out, clip_config.lora_alpha, inv_perm,
               keep_lora)
    _norm(vp["ln_post"], f"{pre}.ln_post", out)
    out[f"{pre}.proj"] = _t(vp["proj"])


def _resnet(vp, vs, clip_config: CLIPConfig, out: Dict[str, torch.Tensor]) -> None:
    """The JAX package's ModifiedResNet params and batch_stats → the
    reference (OpenAI) RN50 keys under ``image_encoder``."""
    pre = "image_encoder"
    for i in (1, 2, 3):
        _conv(vp[f"conv{i}"], f"{pre}.conv{i}", out)
        _bn(vp[f"bn{i}"]["bn"], vs[f"bn{i}"]["bn"], f"{pre}.bn{i}", out)
    for s, blocks in enumerate(clip_config.vision_layers, start=1):
        for b in range(blocks):
            name, dst = f"layer{s}_{b}", f"{pre}.layer{s}.{b}"
            bp, bs = vp[name], vs[name]
            for c in (1, 2, 3):
                _conv(bp[f"conv{c}"], f"{dst}.conv{c}", out)
                _bn(bp[f"bn{c}"]["bn"], bs[f"bn{c}"]["bn"], f"{dst}.bn{c}", out)
            if "downsample_conv" in bp:
                _conv(bp["downsample_conv"], f"{dst}.downsample.0", out)
                _bn(bp["downsample_bn"]["bn"], bs["downsample_bn"]["bn"],
                    f"{dst}.downsample.1", out)
    ap = vp["attnpool"]
    out[f"{pre}.attnpool.positional_embedding"] = _t(ap["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(ap[proj], f"{pre}.attnpool.{proj}", out)


def from_jax_variables(variables: Dict[str, Any], clip_config: CLIPConfig,
                       keep_lora: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's baseline ReID or Uni-Prompt variable tree → the
    port's (reference) state_dict. ``keep_lora`` carries LoRA adapters as
    parameters (a port model built with ``lora_rank``) instead of folding them."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    unknown = sorted(set(params) - set(_REID_KEYS) - set(_UNIPROMPT_KEYS))
    if unknown:
        raise ValueError(f"not a baseline or Uni-Prompt variable tree; unported keys {unknown}")
    out: Dict[str, torch.Tensor] = {}
    if clip_config.is_vit:
        _vit(params["visual"], clip_config, out, keep_lora)
    else:
        _resnet(params["visual"], stats["visual"], clip_config, out)
    for name in ("bottleneck", "bottleneck_proj"):
        _bn(params[name], stats[name], name, out)
    for name in ("classifier", "classifier_proj"):
        head = params[name]  # a margin head's (C, feat) "weight", or a Dense "kernel"
        out[f"{name}.weight"] = (_t(head["weight"]) if "weight" in head
                                 else _t(head["kernel"]).T.contiguous())
    if "cv_embed" in params:
        out["cv_embed"] = _t(params["cv_embed"])
    if "text" in params:
        _text(params["text"], clip_config, out, keep_lora)
    if "prompt_learner" in params:
        pl = params["prompt_learner"]
        for name in ("ctx_generic", "ctx_modality", "ctx_platform"):
            out[f"prompt_learner.{name}"] = _t(pl[name])
        for i in (1, 2):
            _dense(pl[f"ve_linear{i}"], f"prompt_learner.visual_enhanced_net.linear{i}", out)
    if "visual_prompt" in params:
        out["visual_prompt"] = _t(params["visual_prompt"])
    for i in (1, 2):
        if f"fusion_fc{i}" in params:
            _dense(params[f"fusion_fc{i}"], f"image_fusion_net.fc{i}", out)
    return out


def strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_param(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference-layout ``.pth`` into ``model`` (ref make_model.py:118-122),
    or the weights of a training checkpoint of the port, strictly: every key
    must match. A reference Uni-Prompt state_dict is the one exception: it
    holds no ``text_encoder.token_embedding.weight`` (that stays as
    initialised, as the JAX package's overlay leaves it) and may hold the
    prompt learner's ``token_prefix``/``token_suffix`` buffers, which the port
    derives from the token embedding and ignores. A checkpoint write in
    flight (``TPU.ASYNC_CHECKPOINT``) is joined first."""
    from mpreid_tpu_torch.utils.checkpoint import is_checkpoint, wait_for_pending_saves

    wait_for_pending_saves()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if is_checkpoint(sd):
        sd = sd["model"]
    sd = {k: v for k, v in strip_module(sd).items() if k not in _DERIVED_KEYS}
    if _TOKEN_EMBEDDING in model.state_dict() and _TOKEN_EMBEDDING not in sd:
        sd[_TOKEN_EMBEDDING] = model.state_dict()[_TOKEN_EMBEDDING]
    model.load_state_dict(sd, strict=True)
    return model
