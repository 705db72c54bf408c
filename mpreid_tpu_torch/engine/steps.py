"""Train and eval steps.

ref mpreid_tpu/engine/steps.py::make_train_step, ::_train_step_impl,
::make_train_epoch, ::make_eval_step, ::make_image_bank_step, ::make_text_step,
::make_stage1_step, ::_stage1_step_impl. The JAX package compiles one
program per step; PyTorch runs eagerly, so each step is a closure. The train
step moves the uint8 batch to the model's device, augments it there
(``ops/augment.py``), runs ``forward_train``, takes the loss and its
gradients with respect to the trainable parameters only, and lets the
optimizer update them in place. Loss and accuracy come back as device
tensors: nothing in the step waits for the device.

Before each gradient the frozen parameters are set ``requires_grad=False``
and the trainable ones ``True`` (``trainable_params``), so autograd computes
no weight gradient for a frozen tower (the JAX package differentiates with
respect to the trainable partition only). A trainable parameter that the
loss does not reach gets a zero gradient, as under ``jax.value_and_grad``,
so the optimizer's coupled L2 still moves it (an MoE tower's unused gates
under shared routing, for one).

Over a mesh with a model axis (``parallel/mesh.py::shard_module`` has
sliced the model) the layers meet through the Megatron pair, so the ranks
of a model group compute the same replicated loss; a replicated parameter's
gradient comes out whole and equal on each of them, and a sliced one's is
the rank's slice. Gradients are then summed over the data group only.

The whole-epoch scans of ``TPU.DEVICE_DATASET`` (``make_train_epoch``) and
of stage 1 (``make_stage1_epoch``) run their step body through
``engine/compiled.py``: on the card it is captured once into a CUDA graph
(after two eager warm-up steps) and replayed for every batch of the epoch,
so the epoch makes no host round-trip and issues no kernel from Python; on
the CPU the same body runs eagerly. The body gathers its batch on the
device from the epoch's index row, and reads its lr and step from the
optimizer state's device buffers (``solver/optim.py``), so an epoch gives
the step loop's results bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mpreid_tpu_torch.losses import center_loss, supcon_loss
from mpreid_tpu_torch.models.layers import class_split
from mpreid_tpu_torch.models.moe import load_balancing_loss
from mpreid_tpu_torch.ops.augment import eval_preprocess, train_augment
from mpreid_tpu_torch.parallel import collectives as C
from mpreid_tpu_torch.parallel.mesh import global_batch
from mpreid_tpu_torch.solver.optim import CenterOptimizer

from .compiled import CompiledEpoch
from .train_state import TrainState


def labels_for(cfg, batch):
    cam = batch["camids"] if cfg.MODEL.SIE_CAMERA else None
    view = batch["trackids"] if cfg.MODEL.SIE_VIEW else None
    return cam, view


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _to(device, a):
    return None if a is None else torch.as_tensor(a).to(device, non_blocking=True)


def augment_args(cfg) -> dict:
    return dict(mean=tuple(cfg.INPUT.PIXEL_MEAN), std=tuple(cfg.INPUT.PIXEL_STD),
                flip_prob=cfg.INPUT.PROB, padding=cfg.INPUT.PADDING, re_prob=cfg.INPUT.RE_PROB)


def trainable_params(model, optimizer) -> Dict[str, torch.Tensor]:
    """The optimizer's trainable parameters of ``model``, with
    ``requires_grad`` set on them and cleared on the frozen ones."""
    train, frozen = optimizer.partition(model)
    for p in train.values():
        p.requires_grad_(True)
    for p in frozen.values():
        p.requires_grad_(False)
    return train


def _grads(loss: torch.Tensor, inputs):
    """Gradients of ``loss``; zeros for inputs it does not reach."""
    return torch.autograd.grad(loss, inputs, allow_unused=True, materialize_grads=True)


def gather_outputs(out: dict, mesh) -> dict:
    """The per-sample train outputs of every rank's block, concatenated in
    rank order (``all_gather_cat``): the scores and the feats (and
    ``img_feature_proj``, which is feats[2]). The MoE router logits stay
    local: the aux loss sums over the ranks itself (``load_balancing_loss``)."""
    def cat(t):
        return C.all_gather_cat(t, mesh.group)

    full = dict(out, scores=[cat(t) for t in out["scores"]],
                feats=[cat(t) for t in out["feats"]])
    if "img_feature_proj" in out:
        full["img_feature_proj"] = full["feats"][2]
    full.pop("image_features_proj_raw", None)
    return full


def loss_and_grads(model, cfg, loss_fn: Callable, optimizer, x: torch.Tensor,
                   target: torch.Tensor, cam=None, view=None,
                   centers: Optional[torch.Tensor] = None,
                   center_weight: Optional[float] = None,
                   text_features: Optional[torch.Tensor] = None,
                   gen: Optional[torch.Generator] = None, mesh=None,
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor],
                              Optional[torch.Tensor]]:
    """Loss, accuracy, ``{name: gradient}`` over the trainable parameters and
    the centers' gradient (ref ``_train_step_impl``'s ``inner``). The forward
    runs the BNNecks in train mode, so it updates their running statistics.

    With ``text_features`` (Uni-Prompt stage 2, one row per class) the loss
    takes score head 0, feature head 1 and the fp32 image-to-text logits
    ``img_feature_proj · text_featuresᵀ``, and the accuracy comes from those
    logits (ref processor_uniprompt_stage2.py:110-143). Under
    ``MODEL.MOE.ENABLED`` an MoE tower's router logits add
    ``MODEL.MOE.AUX_LOSS_COEFF`` × the mean over gating blocks of
    ``load_balancing_loss`` (ref mpreid_tpu/engine/steps.py:70-75). ``gen`` draws the MoE
    experts' dropout.

    With ``mesh`` (a data-parallel step of more than one rank) ``x`` and the
    labels are this rank's block of the global batch. The forward runs on
    the block, its BatchNorms over the global batch
    (``parallel.mesh.global_batch``); the per-sample outputs and the labels
    are gathered from every rank (``gather_outputs``), and every rank
    computes the single-process loss of the global batch from them. The
    gradients of the parameters, all upstream of that gather, are this
    rank's share and are summed over the ranks (``all_reduce_buckets``);
    the centers sit after it, so their gradient is already the global one
    on every rank and is not summed. With a model axis, all of that runs
    over the mesh's data group (``mesh.group``): the losses take the
    classifiers' split (``class_split``) for their class-parallel form, and
    the accuracy of class-sharded logits is taken from their columns
    gathered (``collectives.gather_columns``)."""
    if mesh is not None and mesh.data == 1:
        mesh = None  # a model axis alone: nothing to gather or sum over data
    train = trainable_params(model, optimizer)
    split = class_split(model.classifier)  # both classifiers split alike
    aux_coeff = cfg.MODEL.MOE.AUX_LOSS_COEFF if cfg.MODEL.MOE.ENABLED else 0.0
    with torch.enable_grad():
        with global_batch(mesh):
            out = model.forward_train(x, target, cam, view, gen=gen)
        if mesh is not None:
            out = gather_outputs(out, mesh)
            target = C.all_gather(target, mesh.group)
            cam = None if cam is None else C.all_gather(cam, mesh.group)
        if text_features is not None:
            logits = torch.matmul(out["img_feature_proj"].float(), text_features.float().t())
            loss = loss_fn(out["scores"][0], out["feats"][1], target, cam, logits,
                           class_split=split)
        else:
            logits = out["scores"][0]
            loss = loss_fn(out["scores"], out["feats"], target, cam, class_split=split)
        if aux_coeff and "router_logits" in out:
            top_k = cfg.MODEL.MOE.TOP_K
            aux = torch.stack([load_balancing_loss(rl, top_k, mesh)
                               for rl in out["router_logits"]])
            loss = loss + aux_coeff * aux.mean()
        inputs = list(train.values())
        if center_weight is not None:
            centers = centers.detach().requires_grad_(True)
            loss = loss + center_weight * center_loss(centers, out["feats"][1], target)
            inputs.append(centers)
        grads = _grads(loss, inputs)
    if split is not None and text_features is None:
        logits = C.gather_columns(logits, split.sizes, split.axis.index, split.axis.group)
    acc = (logits.detach().argmax(dim=-1) == target).float().mean()
    named = dict(zip(train, grads))
    if mesh is not None:
        named = C.all_reduce_buckets(named, mesh.group)
    cgrad = grads[-1] if center_weight is not None else None
    return loss.detach(), acc, named, cgrad


def _make_step_body(model, cfg, loss_fn: Callable, optimizer, center_weight, center_lr,
                    uniprompt: bool, text_features, mesh=None):
    """The body shared by ``make_train_step`` and ``make_train_epoch`` (ref
    ``_train_step_impl``): ``body(state, images, target, cam, view, gen)``
    on device tensors augments the uint8 batch with ``gen``, takes the loss
    and gradients and updates the state in place, at the lr in
    ``state.opt_state.lr`` → (state, {"loss", "acc"}).

    With ``mesh`` (data parallel over more than one rank) the batch is this
    rank's block of the global one: it takes its rows of the global batch's
    augmentation draws (``train_augment``'s ``shard``) and the data-parallel
    ``loss_and_grads``, so from one state and generator state the ranks
    together take the single-process step of the global batch. The loss and
    accuracy are the global batch's, the same on every rank."""
    mesh = mesh if mesh is not None and (mesh.data > 1 or mesh.model > 1) else None
    shard = None if mesh is None or mesh.data == 1 else (mesh.data, mesh.rank)
    aug = augment_args(cfg)
    device = _device_of(model)
    center_opt = CenterOptimizer(center_lr, center_weight) if center_weight is not None else None
    text = text_features.to(device) if uniprompt and text_features is not None else None

    def body(state: TrainState, images, target, cam, view, gen: torch.Generator):
        x = train_augment(images, gen, **aug, shard=shard)
        loss, acc, grads, cgrad = loss_and_grads(
            state.model, cfg, loss_fn, optimizer, x, target.long(), cam, view,
            state.centers, center_weight, text, gen, mesh)
        if center_opt is not None:
            center_opt.update(cgrad, state.centers)
        train, _ = optimizer.partition(state.model)
        optimizer.update(grads, state.opt_state, train)
        return state, {"loss": loss, "acc": acc}

    return body


def make_train_step(model, cfg, loss_fn: Callable, optimizer,
                    center_weight: Optional[float] = None,
                    center_lr: Optional[float] = None,
                    uniprompt: bool = False,
                    text_features: Optional[torch.Tensor] = None, mesh=None):
    """Baseline / Uni-Prompt stage-2 train step (ref processor.py:57-88 and
    processor_uniprompt_stage2.py:88-156 hot loops) →
    ``step(state, batch, lr, gen) → (state, {"loss", "acc"})``.

    ``batch`` holds uint8 ``images`` (B, H, W, 3) and int ``pids``,
    ``camids``, ``trackids``, as numpy arrays or tensors; ``gen`` is a
    ``torch.Generator`` on the model's device that draws the augmentation
    (and the MoE experts' dropout). With ``center_weight`` the center loss
    joins, and the centers take an SGD step on their gradient rescaled by
    1/``center_weight``. With ``uniprompt`` and ``text_features`` the
    image-to-text term joins (``loss_and_grads``). With ``mesh`` of more
    than one rank, ``batch`` is this rank's block of the global batch and
    the step is the data-parallel one (``_make_step_body``)."""
    device = _device_of(model)
    body = _make_step_body(model, cfg, loss_fn, optimizer, center_weight, center_lr,
                           uniprompt, text_features, mesh)

    def step(state: TrainState, batch, lr: float, gen: torch.Generator):
        optimizer.set_lr(state.opt_state, lr)
        cam, view = (_to(device, a) for a in labels_for(cfg, batch))
        return body(state, _to(device, batch["images"]), _to(device, batch["pids"]), cam, view,
                    gen)

    return step


def state_tensors(state: TrainState) -> list:
    """Every tensor of ``state`` a step reads or updates in place: the
    model's parameters and buffers, the moments, the step, the lr and the
    centers."""
    opt = state.opt_state
    return [*state.model.parameters(), *state.model.buffers(), *opt.mu.values(),
            *opt.nu.values(), opt.step, opt.lr, *([] if state.centers is None else [state.centers])]


def make_train_epoch(model, cfg, loss_fn: Callable, optimizer,
                     center_weight: Optional[float] = None,
                     center_lr: Optional[float] = None,
                     uniprompt: bool = False,
                     text_features: Optional[torch.Tensor] = None):
    """A whole epoch over a device-resident dataset (``TPU.DEVICE_DATASET``,
    ref ``make_train_epoch``) →
    ``epoch(state, images, pids, camids, trackids, perm, lr, gen) →
    (state, (losses, accs))``.

    ``images`` (N, H, W, 3) uint8 and the int label vectors live on the
    model's device (``processor.build_device_dataset``); ``perm`` is the
    (n_batches, B) index matrix of the epoch (``processor.epoch_perm``),
    uploaded once. For each row the batch is gathered on the device by
    index and goes through the step's own body (``_make_step_body``), run
    by ``compiled.CompiledEpoch``: on the card two eager warm-up steps, then
    one captured CUDA graph replayed for every later row (and every row of
    later epochs); on the CPU the body, eagerly. From the same state and
    generator the epoch equals ``make_train_step`` over the same batches
    bit for bit. Losses and accuracies stay on the device until the epoch
    ends: nothing in the epoch waits for it. ``epoch.release()`` frees the
    graph; ``epoch.compiled.stats`` counts captures, replays and eager
    steps and holds the graph pool's bytes."""
    device = _device_of(model)
    body = _make_step_body(model, cfg, loss_fn, optimizer, center_weight, center_lr,
                           uniprompt, text_features)
    sie_cam, sie_view = cfg.MODEL.SIE_CAMERA, cfg.MODEL.SIE_VIEW
    compiled = CompiledEpoch(device)

    def epoch(state: TrainState, images, pids, camids, trackids, perm, lr: float,
              gen: torch.Generator):
        optimizer.set_lr(state.opt_state, lr)

        def step(idx):
            cam = camids.index_select(0, idx) if sie_cam else None
            view = trackids.index_select(0, idx) if sie_view else None
            _, metrics = body(state, images.index_select(0, idx), pids.index_select(0, idx),
                              cam, view, gen)
            return metrics["loss"], metrics["acc"]

        losses, accs = compiled.run(step, perm, gen, [*state_tensors(state), images, pids,
                                                      camids, trackids])
        return state, (losses, accs)

    epoch.compiled = compiled
    epoch.release = compiled.release
    return epoch


def make_eval_step(model, cfg):
    """→ ``step(batch)``: numpy batch dict → features on the device."""
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    device = _device_of(model)

    @torch.inference_mode()
    def step(batch) -> torch.Tensor:
        x = eval_preprocess(_to(device, batch["images"]), mean=mean, std=std)
        cam, view = labels_for(cfg, batch)
        return model.forward_eval(x, _to(device, cam), _to(device, view))

    return step


def make_image_bank_step(model, cfg):
    """→ ``step(batch)``: the frozen encoder's projected class-token features
    of a numpy batch, on the device (stage-1 bank, ref
    processor_uniprompt_stage1.py:41-64). ``no_grad``, not
    ``inference_mode``: the bank enters stage 1's differentiated loss."""
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    device = _device_of(model)

    @torch.no_grad()
    def step(batch) -> torch.Tensor:
        return model.get_image(eval_preprocess(_to(device, batch["images"]), mean=mean, std=std))

    return step


def make_text_step(model, stage: str):
    """→ ``step(labels, views=None)``: prompted text features of the labels
    for ``stage`` (ref make_model_uniprompt.py:160-170), without a gradient."""
    device = _device_of(model)

    @torch.no_grad()
    def step(labels, views=None) -> torch.Tensor:
        views = None if views is None else _to(device, views).long()
        return model.get_text(_to(device, labels).long(), views, stage)

    return step


def stage1_loss_and_grads(model, optimizer, stage: str, image_feats: torch.Tensor,
                          target: torch.Tensor, views: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SupCon(i2t) + SupCon(t2i) of the prompted text features against image
    features, and ``{name: gradient}`` over the trainable (context)
    parameters (ref ``_stage1_step_impl``'s ``inner``). The gradient reaches
    the contexts through the frozen text tower."""
    train = trainable_params(model, optimizer)
    with torch.enable_grad():
        text = model.get_text(target, views, stage)
        loss = (supcon_loss(image_feats, text, target, target)
                + supcon_loss(text, image_feats, target, target))
        grads = _grads(loss, list(train.values()))
    return loss.detach(), dict(zip(train, grads))


def _make_stage1_body(optimizer, stage: str):
    """The body shared by ``make_stage1_step`` and ``make_stage1_epoch``
    (ref ``_stage1_step_impl``): ``body(state, image_feats, target, views)``
    on device tensors takes ``stage1_loss_and_grads`` and updates the
    contexts in place, at the lr in ``state.opt_state.lr`` → the loss."""

    def body(state: TrainState, image_feats, target, views) -> torch.Tensor:
        loss, grads = stage1_loss_and_grads(state.model, optimizer, stage, image_feats,
                                            target, views)
        train, _ = optimizer.partition(state.model)
        optimizer.update(grads, state.opt_state, train)
        return loss

    return body


def make_stage1_step(model, cfg, optimizer, stage: str):
    """Prompt-context step (ref processor_uniprompt_stage1.py:72-98) →
    ``step(state, image_feats, target, views, lr) → (state, {"loss"})``;
    ``stage`` is ``'1a'`` or ``'1b'``, ``views`` None in 1a."""
    device = _device_of(model)
    body = _make_stage1_body(optimizer, stage)

    def step(state: TrainState, image_feats, target, views, lr: float):
        optimizer.set_lr(state.opt_state, lr)
        views = None if views is None else _to(device, views).long()
        loss = body(state, _to(device, image_feats), _to(device, target).long(), views)
        return state, {"loss": loss}

    return step


def make_stage1_epoch(model, cfg, optimizer, stage: str):
    """Whole stage-1 epoch (ref ``make_stage1_epoch``: one compiled scan,
    no host round-trip) →
    ``epoch(state, feats_bank, labels_bank, views_bank, perm, lr) →
    (state, losses)``.

    The bank (features, labels, views) lives on the model's device;
    ``perm`` is the (n_batches, B) index matrix of the epoch's full
    batches. Each row's bank rows are gathered on the device and go through
    the step's own body (``_make_stage1_body``), run by
    ``compiled.CompiledEpoch`` (a captured CUDA graph on the card, the body
    eagerly on the CPU), so the epoch equals ``make_stage1_step`` over the
    same rows bit for bit. The
    views enter in ``'1b'`` only. ``losses`` (n_batches,) stay on the
    device. ``epoch.release()`` frees the graph."""
    body = _make_stage1_body(optimizer, stage)
    compiled = CompiledEpoch(_device_of(model))

    def epoch(state: TrainState, feats_bank, labels_bank, views_bank, perm, lr: float):
        optimizer.set_lr(state.opt_state, lr)

        def step(idx):
            views = views_bank.index_select(0, idx).long() if stage == "1b" else None
            return (body(state, feats_bank.index_select(0, idx),
                         labels_bank.index_select(0, idx).long(), views),)

        (losses,) = compiled.run(step, perm, None, [*state_tensors(state), feats_bank,
                                                     labels_bank, views_bank])
        return state, losses

    epoch.compiled = compiled
    epoch.release = compiled.release
    return epoch
