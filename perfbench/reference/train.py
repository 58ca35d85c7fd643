"""The VAE branch's training step in plain float32 PyTorch (erprogs/GenConViT
train/train_vae.py with train.py's optimizer): cross-entropy plus the
reconstruction's summed squared error over the batch's elements (the KL
term stays off, as the reference leaves it commented out), autograd, then
Adam with L2 decay added to the gradient (torch.optim.Adam's rule, written
out), and BatchNorm's running statistics from the batch (momentum 0.1,
unbiased variance) written after the step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.model import EXACT, Operands, normalize, sample_z, vae_encoder, vae_tail

BETAS = (0.9, 0.999)
EPS = 1e-8


def is_bn_stat(key: str) -> bool:
    return key.endswith("running_mean") or key.endswith("running_var")


def vae_loss(sd: Dict[str, torch.Tensor], images_u8: torch.Tensor, labels: torch.Tensor,
             eps: torch.Tensor, cfg: dict, op: Operands = EXACT) -> Tuple[torch.Tensor, List]:
    """(loss, the encoder BatchNorms' new running statistics)."""
    x = normalize(images_u8)
    flat, stats = vae_encoder(sd, x, train=True, op=op)
    mu = op.linear(flat, sd["encoder.mu.weight"], sd["encoder.mu.bias"])
    op.linear(flat, sd["encoder.var.weight"], sd["encoder.var.bias"])   # logvar: unused, no KL
    logits, x_hat = vae_tail(sd, x, sample_z(mu, eps), cfg, op)
    recon = F.interpolate(x_hat, size=x.shape[2:], mode="bilinear", align_corners=False,
                          antialias=True)
    n = x.shape[0]
    loss = F.cross_entropy(logits, labels) + (recon - x).square().sum() / (n * x[0].numel())
    return loss, stats


class Trainer:
    """Float32 masters, Adam's moments and the step count, over a state dict."""

    def __init__(self, sd: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 op: Operands = EXACT):
        self.sd = sd
        self.op = op
        self.params = [k for k, v in sd.items() if v.is_floating_point() and not is_bn_stat(k)]
        self.lr, self.wd = lr, weight_decay
        self.m = {k: torch.zeros_like(sd[k]) for k in self.params}
        self.v = {k: torch.zeros_like(sd[k]) for k in self.params}
        self.t = 0

    def step(self, images_u8, labels, eps, cfg: dict) -> Tuple[float, Dict[str, float],
                                                                Dict[str, float]]:
        """One step: (loss, each leaf's gradient norm as the optimizer takes
        it, with the decay term, and without it)."""
        leaves = {k: self.sd[k].detach().requires_grad_(True) for k in self.params}
        loss, stats = vae_loss({**self.sd, **leaves}, images_u8, labels, eps, cfg, self.op)
        grads = torch.autograd.grad(loss, [leaves[k] for k in self.params], allow_unused=True)
        self.t += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        taken, raw = {}, {}
        with torch.no_grad():
            for k, g in zip(self.params, grads):
                p = self.sd[k]
                g = torch.zeros_like(p) if g is None else g
                raw[k] = g.norm().item()
                g = g + self.wd * p
                taken[k] = g.norm().item()
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(EPS)
                self.sd[k] = p - (self.lr / bc1) * self.m[k] / denom
            for i, (mean, var) in enumerate(stats):
                bn = f"encoder.features.{3 * i + 1}"
                self.sd[bn + ".running_mean"] = mean
                self.sd[bn + ".running_var"] = var
        return loss.item(), taken, raw


def change_norms(sd: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor],
                 keys: Optional[List[str]] = None) -> Dict[str, float]:
    return {k: (sd[k].float() - start[k].float()).norm().item()
            for k in (keys or [k for k, v in sd.items() if v.is_floating_point()])}
