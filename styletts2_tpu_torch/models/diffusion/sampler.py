"""EDM/Karras preconditioning, its training loss, the Karras schedule and the
ADPM2 sampler (ref: Modules/diffusion/sampler.py).

The JAX package draws its noise from keys (each sampler step's from
``fold_in(key, i)``); here every draw is an explicit input, so a test can
feed the port the noise JAX drew.
"""

from __future__ import annotations

from typing import Callable

import torch


def log_normal_sigmas(normals: torch.Tensor, mean: float = -3.0, std: float = 1.0
                      ) -> torch.Tensor:
    """LogNormal training sigmas from standard normals (ref: sampler.py:24-33)."""
    return torch.exp(mean + std * normals)


def k_scale_weights(sigmas: torch.Tensor, sigma_data: float):
    """(c_skip, c_out, c_in, c_noise) per Karras et al. (ref: sampler.py:184-191)."""
    c_noise = torch.log(sigmas) * 0.25
    s = sigmas[:, None, None]
    c_skip = (sigma_data ** 2) / (s ** 2 + sigma_data ** 2)
    c_out = s * sigma_data * (sigma_data ** 2 + s ** 2) ** -0.5
    c_in = (s ** 2 + sigma_data ** 2) ** -0.5
    return c_skip, c_out, c_in, c_noise


def k_denoise_fn(net: Callable, sigma_data: float) -> Callable:
    """``x0_hat = c_skip*x + c_out*net(c_in*x, c_noise)`` (ref: sampler.py:193-208)."""

    def fn(x_noisy: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
        c_skip, c_out, c_in, c_noise = k_scale_weights(sigmas, sigma_data)
        return c_skip * x_noisy + c_out * net(c_in * x_noisy, c_noise)

    return fn


def k_diffusion_loss(net: Callable, x: torch.Tensor, sigma_data, sigma_normals: torch.Tensor,
                     noise: torch.Tensor, dist_mean: float = -3.0, dist_std: float = 1.0
                     ) -> torch.Tensor:
    """The EDM-weighted denoising loss (ref: sampler.py:214-233) of clean
    latents x (B, 1, C): sigmas from ``sigma_normals`` (B,), ``noise`` x's
    shape; ``sigma_data`` a float or a 0-dim tensor."""
    sigmas = log_normal_sigmas(sigma_normals, dist_mean, dist_std)
    x_noisy = x + sigmas[:, None, None] * noise
    x_denoised = k_denoise_fn(net, sigma_data)(x_noisy, sigmas)
    losses = torch.mean(torch.square(x_denoised - x), dim=tuple(range(1, x.dim())))
    weight = (sigmas ** 2 + sigma_data ** 2) * (sigmas * sigma_data) ** -2
    return torch.mean(losses * weight)


def karras_schedule(num_steps: int, sigma_min: float = 1e-4, sigma_max: float = 3.0,
                    rho: float = 9.0, device=None) -> torch.Tensor:
    """Karras et al. eq. 5 in f32, padded with a trailing 0 (ref: sampler.py:318-336)."""
    rho_inv = 1.0 / rho
    steps = torch.arange(num_steps, dtype=torch.float32, device=device)
    sigmas = (sigma_max ** rho_inv + (steps / (num_steps - 1))
              * (sigma_min ** rho_inv - sigma_max ** rho_inv)) ** rho
    return torch.cat([sigmas, sigmas.new_zeros(1)])


def _batched(fn: Callable, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return fn(x, sigma.expand(x.shape[0]))


def adpm2_step(x: torch.Tensor, fn: Callable, sigma, sigma_next,
               noise: torch.Tensor, rho: float = 1.0) -> torch.Tensor:
    """One DPM-2 ancestral step (ref: sampler.py:489-509)."""
    sigma_up = torch.sqrt(sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2)
    sigma_down = torch.sqrt(sigma_next ** 2 - sigma_up ** 2)
    sigma_mid = ((sigma ** (1.0 / rho) + sigma_down ** (1.0 / rho)) / 2.0) ** rho
    d = (x - _batched(fn, x, sigma)) / sigma
    x_mid = x + d * (sigma_mid - sigma)
    d_mid = (x_mid - _batched(fn, x_mid, sigma_mid)) / sigma_mid
    x = x + d_mid * (sigma_down - sigma)
    return x + noise * sigma_up


def adpm2_sample(noise: torch.Tensor, fn: Callable, sigmas: torch.Tensor,
                 num_steps: int, step_noise: torch.Tensor, rho: float = 1.0,
                 clamp: bool = True) -> torch.Tensor:
    """ADPM2 sampling loop (ref: sampler.py:511-518).

    ``noise`` (B, 1, C) is the initial latent noise; ``step_noise``
    (num_steps-1, B, 1, C) the ancestral noise of each step.
    """
    if step_noise.shape != (num_steps - 1, *noise.shape):
        raise ValueError(f"step_noise {tuple(step_noise.shape)} != "
                         f"{(num_steps - 1, *noise.shape)}")
    x = sigmas[0] * noise
    for i in range(num_steps - 1):
        x = adpm2_step(x, fn, sigmas[i], sigmas[i + 1], step_noise[i], rho)
    return torch.clamp(x, -1.0, 1.0) if clamp else x
