"""GAN and VAE losses (``vispeech_tpu/train/losses.py``), all in f32."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r: Sequence[Sequence[torch.Tensor]],
                 fmap_g: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """2 · Σ mean|real − fake| over every feature map; real maps detached."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real, disc_fake) -> Tuple[torch.Tensor, List, List]:
    """LSGAN: Σ mean((1 − real)²) + mean(fake²)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_fake):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_fake) -> Tuple[torch.Tensor, List]:
    """LSGAN: Σ mean((1 − fake)²)."""
    losses = [torch.mean((1.0 - dg.float()) ** 2) for dg in disc_fake]
    return sum(losses), losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """Masked KL(q ‖ p) on the flow-mapped posterior sample."""
    z_p, logs_q, m_p, logs_p, z_mask = (t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)
