"""Linear layer matching torch layout: w (out, in), y = x @ w.T + b.

Mixed dtypes promote, as ``jnp.dot`` does: an f32 input against bf16
weights (the duration encoder under a bf16 zoo) computes in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))
