"""Training state: the model (parameters and BN buffers), the optimizer's
moments and step, and the center-loss centers.

ref mpreid_tpu/engine/train_state.py::TrainState, ::initial_state. The JAX
package threads an immutable pytree through its steps; the port updates
the model, the moments, the step and the centers in place and hands the
same state back (a captured step writes the same tensors every replay).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mpreid_tpu_torch.solver.optim import OptState


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt_state: OptState
    centers: Optional[torch.Tensor] = None
    # the model's whole state dict, where a checkpoint needs it gathered
    # (engine/processor.py::checkpoint_state); else the model's own is taken
    model_state: Optional[dict] = None


def initial_state(model, optimizer, centers: Optional[torch.Tensor] = None) -> TrainState:
    """The state of a run from ``model``: fresh moments and step, and a
    copy of ``centers`` (the steps update the state's centers in place,
    never the caller's tensor)."""
    return TrainState(model=model, opt_state=optimizer.init(model),
                      centers=None if centers is None else centers.detach().clone())
