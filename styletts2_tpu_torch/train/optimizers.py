"""Per-net optimizers (ref: optimizers.py).

The reference builds one AdamW (betas (0, 0.99), eps 1e-9, weight decay
1e-4) and a OneCycleLR per net and steps subsets of the nets per phase.
Its OneCycle has div_factor = final_div_factor = 1 and pct_start 0
(ref: optimizers.py:110-120), a constant max_lr: here the learning rates are
constant.

Stage 2's SLM adversarial update also rescales the gradients of its nets to
a global norm and scales some of them by 0.01 (``clip_by_global_norm_if_above``,
``scale_module_grads``), in place on the parameters' ``.grad``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

import torch
from torch import nn


class MultiOptimizer:
    """One ``torch.optim.AdamW`` per net of ``nets``; ``step(active)``
    updates only the nets named."""

    def __init__(self, nets: nn.ModuleDict, lr_map: Mapping[str, float],
                 default_lr: float = 1e-4, weight_decay: float = 1e-4):
        self.nets = nets
        self.opts: Dict[str, torch.optim.AdamW] = {
            name: torch.optim.AdamW(net.parameters(), lr=lr_map.get(name, default_lr),
                                    betas=(0.0, 0.99), eps=1e-9, weight_decay=weight_decay)
            for name, net in nets.items()}

    def zero_grad(self, active: Iterable[str]) -> None:
        for name in active:
            self.opts[name].zero_grad(set_to_none=True)

    def step(self, active: Iterable[str]) -> None:
        """One update of each active net.  A parameter with no gradient
        (outside the loss) takes a zero one, so its weight decay still
        applies, as in the JAX package's optax update."""
        for name in active:
            for p in self.nets[name].parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.opts[name].step()


def _grads(modules: Iterable[nn.Module]) -> List[torch.Tensor]:
    return [p.grad for m in modules for p in m.parameters() if p.grad is not None]


def global_grad_norm(modules: Iterable[nn.Module]) -> torch.Tensor:
    """The L2 norm of every gradient of ``modules``' parameters, a
    parameter without one counting as a zero gradient (0-dim tensor)."""
    grads = _grads(modules)
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


def clip_by_global_norm_if_above(modules: Iterable[nn.Module], thresh: float) -> torch.Tensor:
    """Rescale the gradients of ``modules`` to the global norm ``thresh``
    when their norm exceeds it (ref: train_second.py:856-866); returns the
    norm before, on the device, with no host sync."""
    modules = list(modules)
    norm = global_grad_norm(modules)
    scale = torch.where(norm > thresh, thresh / (norm + 1e-12), torch.ones_like(norm))
    for g in _grads(modules):
        g.mul_(scale)
    return norm


def scale_module_grads(modules: Iterable[nn.Module], scale: float) -> None:
    """Multiply the gradients of ``modules`` by ``scale`` (ref:
    train_second.py:868-882 scales the diffusion's and the predictor's
    duration head's by 0.01 in the SLM adversarial update)."""
    for g in _grads(modules):
        g.mul_(scale)
