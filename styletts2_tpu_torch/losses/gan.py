"""GAN losses: LSGAN, feature matching and the TPRLS relativistic median
losses (ref: losses.py:99-192).

TPRLS selects the elements ``dr < dg + median(dr - dg)``; the selection is
a masked mean, as in the JAX package.  Its median is the midpoint of the two
middle values for an even count, as ``jnp.median`` takes it (``torch.median``
returns the lower one).
"""

from __future__ import annotations

from typing import Sequence

import torch

TAU = 0.04


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of every element; the midpoint of the two middle values when
    their count is even (``jnp.median``)."""
    s, _ = torch.sort(x.reshape(-1))
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def feature_loss(fmap_r: Sequence, fmap_g: Sequence) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl), dtype=torch.float32)
    return loss * 2.0


def discriminator_loss(real_outputs: Sequence, generated_outputs: Sequence) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(real_outputs, generated_outputs):
        dr, dg = dr.float(), dg.float()
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_loss(generated_outputs: Sequence) -> torch.Tensor:
    loss = 0.0
    for dg in generated_outputs:
        loss = loss + torch.mean((1.0 - dg.float()) ** 2)
    return loss


def _tprls(dr: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    dr, dg = dr.float(), dg.float()
    diff = dr - dg
    m_dg = median(diff)
    mask = dr < dg + m_dg
    sq = ((diff - m_dg) ** 2) * mask
    l_rel = sq.sum() / torch.clamp(mask.sum(), min=1)
    return TAU - torch.clamp(TAU - l_rel, min=0.0)


def tprls_loss(real_outputs: Sequence, generated_outputs: Sequence) -> torch.Tensor:
    """Both sides' TPRLS loss: the reference's generator form swaps the zip
    order but computes the same statistic (ref: losses.py:142-149)."""
    loss = 0.0
    for dr, dg in zip(real_outputs, generated_outputs):
        loss = loss + _tprls(dr, dg)
    return loss


def generator_loss_full(mpd_out, msd_out) -> torch.Tensor:
    """GeneratorLoss.forward (ref: losses.py:151-170): LSGAN, feature
    matching and TPRLS over both discriminators; ``*_out`` are the (real
    scores, fake scores, real fmaps, fake fmaps) of ``mpd_apply``/``msd_apply``."""
    y_df_r, y_df_g, fmap_f_r, fmap_f_g = mpd_out
    y_ds_r, y_ds_g, fmap_s_r, fmap_s_g = msd_out
    return (generator_loss(y_df_g) + generator_loss(y_ds_g)
            + feature_loss(fmap_f_r, fmap_f_g) + feature_loss(fmap_s_r, fmap_s_g)
            + tprls_loss(y_df_r, y_df_g) + tprls_loss(y_ds_r, y_ds_g))


def discriminator_loss_full(mpd_out, msd_out) -> torch.Tensor:
    """DiscriminatorLoss.forward (ref: losses.py:172-192)."""
    y_df_r, y_df_g, _, _ = mpd_out
    y_ds_r, y_ds_g, _, _ = msd_out
    return (discriminator_loss(y_df_r, y_df_g) + discriminator_loss(y_ds_r, y_ds_g)
            + tprls_loss(y_df_r, y_df_g) + tprls_loss(y_ds_r, y_ds_g))
