"""Linear layer matching torch layout: w (out, in), y = x @ w.T + b."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, w, b)
