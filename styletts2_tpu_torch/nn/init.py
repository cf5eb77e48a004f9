"""Parameter initialisers reproducing torch defaults, in place on tensors
(the port of ``styletts2_tpu/nn/init.py``).

Matching init *distributions* (not streams) keeps from-scratch training
dynamics comparable with the reference.  Every draw comes from an explicit
CPU ``torch.Generator`` and is copied to the tensor's device, so a seed
gives the same weights on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def fan_in_out(shape: Sequence[int]) -> Tuple[int, int]:
    """Fan-in/out for a torch-layout weight (out, in, *kernel) or (out, in)."""
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _fill_(t: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return t.copy_(values.to(device=t.device, dtype=t.dtype))


def uniform_(t: torch.Tensor, generator: torch.Generator, bound: float) -> torch.Tensor:
    """U(-bound, bound)."""
    u = torch.rand(tuple(t.shape), generator=generator, dtype=torch.float32)
    return _fill_(t, (2.0 * u - 1.0) * bound)


def normal_(t: torch.Tensor, generator: torch.Generator, std: float = 1.0,
            mean: float = 0.0) -> torch.Tensor:
    n = torch.randn(tuple(t.shape), generator=generator, dtype=torch.float32)
    return _fill_(t, mean + std * n)


def kaiming_uniform_(t: torch.Tensor, generator: torch.Generator,
                     a: float = math.sqrt(5.0)) -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_ on a torch-layout weight."""
    fan_in, _ = fan_in_out(t.shape)
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return uniform_(t, generator, gain * math.sqrt(3.0 / fan_in))


def conv_bias_(t: torch.Tensor, generator: torch.Generator,
               weight_shape: Sequence[int]) -> torch.Tensor:
    """torch Conv/Linear default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in, _ = fan_in_out(weight_shape)
    return uniform_(t, generator, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator,
                    gain: float = 1.0) -> torch.Tensor:
    fan_in, fan_out = fan_in_out(t.shape)
    return uniform_(t, generator, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def uniform_sqrt_hidden_(t: torch.Tensor, generator: torch.Generator,
                         hidden_size: int) -> torch.Tensor:
    """torch LSTM default: U(-1/sqrt(H), 1/sqrt(H)) for every parameter."""
    return uniform_(t, generator, 1.0 / math.sqrt(hidden_size))


def hifigan_conv_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """HiFi-GAN ``init_weights``: N(0, 0.01) (ref: Modules/utils.py style)."""
    return normal_(t, generator, std=0.01)
