"""Per-net optimizers (ref: optimizers.py).

The reference builds one AdamW (betas (0, 0.99), eps 1e-9, weight decay
1e-4) and a OneCycleLR per net and steps subsets of the nets per phase.
Its OneCycle has div_factor = final_div_factor = 1 and pct_start 0
(ref: optimizers.py:110-120), a constant max_lr: here the learning rates are
constant.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

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
