"""Full-state training checkpoints with ``torch.save``/``torch.load``.

ref mpreid_tpu/utils/checkpoint.py::save_checkpoint, ::load_checkpoint. The
JAX package writes orbax directories; the port writes one ``.pth`` file
holding the model's state_dict (parameters and BN buffers, the reference
layout), the optimizer's step and moments, the center-loss centers and the
epoch, so ``SOLVER.RESUME`` continues a run exactly where it stopped.
``models/convert.py::load_param`` also reads the weights out of such a
file, so ``python -m mpreid_tpu_torch.test TEST.WEIGHT`` takes it.

A ZeRO-1 run (``parallel/zero.py``) writes its moments gathered to the
parameters' shapes (``engine/processor.py::checkpoint_state``), the layout
of a replicated run, from rank 0 alone; ``restore_state`` with the ZeRO
optimizer cuts them back to each rank's slices. A model sliced over a model
axis (``parallel/mesh.py::shard_module``) is written whole the same way,
its parameters and moments gathered, and ``restore_state`` slices them
again. So one file resumes a run with or without ZeRO or a model axis, at
any number of ranks, and a resumed ZeRO run stays bitwise with an
uninterrupted one.

``TPU.ASYNC_CHECKPOINT`` (ref ``save_checkpoint``'s single-slot writer,
``wait_for_pending_saves``): the payload is copied to the host in the
caller's thread, synchronously (the next step updates the parameters and
moments in place, so the copy must be made before it, and a CPU tensor's
``.cpu()`` would alias them), and only the ``torch.save`` and the rename
run on one background thread. One slot: a new save joins the previous
write first and re-raises its failure, and so does
``wait_for_pending_saves``, which the training loops call when they end;
``load_checkpoint`` and ``models/convert.py::load_param`` join before they
read.
"""

from __future__ import annotations

import os
import threading

import torch

from mpreid_tpu_torch.parallel.mesh import load_full_state_dict, local_moment

FORMAT = "mpreid_tpu_torch.train_state.v1"


def _cpu(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """``t`` on the host; with ``copy`` a tensor of its own, even where
    ``t`` already lies on the CPU (a synchronous device-to-host copy on the
    card)."""
    return t.detach().to("cpu", copy=copy)


# the write in flight under TPU.ASYNC_CHECKPOINT: (thread, path, its error)
_PENDING_SAVE: list = []


def wait_for_pending_saves() -> None:
    """Join the checkpoint write in flight, re-raising its failure as a
    ``RuntimeError`` (once: the slot is empty after)."""
    while _PENDING_SAVE:
        thread, path, errbox = _PENDING_SAVE.pop()
        thread.join()
        if errbox:
            raise RuntimeError(f"async checkpoint write to {path} failed") from errbox[0]


def save_checkpoint(path: str, state, epoch: int, cfg=None) -> str:
    """Write ``state`` (engine.train_state.TrainState) after ``epoch`` to
    ``path`` (atomically: a temporary file, then a rename). With
    ``cfg.TPU.ASYNC_CHECKPOINT`` the host copy is made here and the write
    runs on a background thread (``wait_for_pending_saves``)."""
    background = cfg is not None and bool(cfg.TPU.ASYNC_CHECKPOINT)

    def host(tensors: dict) -> dict:
        return {k: _cpu(v, background) for k, v in tensors.items()}

    payload = {
        "format": FORMAT,
        "epoch": int(epoch),
        "model": host(state.model_state if state.model_state is not None
                      else state.model.state_dict()),
        "opt_state": {"step": int(state.opt_state.step), "mu": host(state.opt_state.mu),
                      "nu": host(state.opt_state.nu)},
        "centers": None if state.centers is None else _cpu(state.centers, background),
    }

    def write():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    if not background:
        write()
        return path
    wait_for_pending_saves()  # one slot; surfaces the previous write's failure
    errbox: list = []

    def guarded():
        try:
            write()
        except BaseException as e:  # re-raised at the join
            errbox.append(e)

    thread = threading.Thread(target=guarded, name="mpreid-ckpt-writer", daemon=False)
    thread.start()
    _PENDING_SAVE.append((thread, path, errbox))
    return path


def is_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and obj.get("format") == FORMAT


def load_checkpoint(path: str) -> dict:
    """The payload of a file ``save_checkpoint`` wrote, tensors on the CPU
    (a write in flight is joined first)."""
    wait_for_pending_saves()
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not is_checkpoint(payload):
        raise ValueError(f"{path} is not a training checkpoint of the port ({FORMAT})")
    return payload


def restore_state(state, payload: dict, optimizer=None) -> int:
    """Load ``payload`` into ``state`` in place (model, moments, step,
    centers) on the state's devices → the epoch it was saved after. With a
    ZeRO ``optimizer`` each ZeRO'd moment takes this rank's slice of the
    file's whole one; a model sliced over a model axis takes its slices of
    the whole parameters and moments."""
    shard = getattr(optimizer, "sharded", None)
    load_full_state_dict(state.model, payload["model"], strict=True)
    opt = payload["opt_state"]
    for key in ("mu", "nu"):
        mine, theirs = getattr(state.opt_state, key), opt[key]
        if set(mine) != set(theirs):
            raise ValueError(f"checkpoint moments {key} cover other parameters than the optimizer's")
        for name, t in mine.items():
            whole = local_moment(name, theirs[name], state.model)
            t.copy_(whole if shard is None else shard(name, whole))
    state.opt_state.step.fill_(int(opt["step"]))  # in place: a captured epoch reads it
    if payload["centers"] is not None:
        if state.centers is None:
            device = next(state.model.parameters()).device
            state.centers = payload["centers"].to(device)
        else:
            state.centers.copy_(payload["centers"])
    return int(payload["epoch"])
