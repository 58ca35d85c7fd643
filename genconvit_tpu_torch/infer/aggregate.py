"""Per-video aggregation with the reference's semantics (port of
genconvit_tpu/infer/aggregate.py:21-57), batched over any leading axes.

Sigmoid (not softmax) of the per-frame 2-class logits, masked mean over
frames, argmax; y_val is a pseudo-P(fake): mean[0] if class 0 wins, else
|1 - mean[1]| (quirk B3). Class 0 = FAKE at the model output (quirk B2).
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_prob_sums(logits: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [..., K, 2], mask [..., K] -> (masked sigmoid sums [..., 2],
    mask count [...])."""
    probs = torch.sigmoid(logits.float())
    mask = mask.float()
    return (probs * mask[..., None]).sum(-2), mask.sum(-1)


def finish_aggregate(sum_probs: torch.Tensor, count: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums [..., 2], count [...]) -> (y int [...], y_val f32 [...])."""
    mean_val = sum_probs / count.clamp(min=1.0)[..., None]
    y = torch.argmax(mean_val, dim=-1)
    y_val = torch.where(mean_val[..., 0] > mean_val[..., 1], mean_val[..., 0],
                        (1.0 - mean_val[..., 1]).abs())
    return y, y_val


def aggregate_logits(logits: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For the ensemble, K = 2F and the mask is the frame mask twice (ED
    rows then VAE rows)."""
    return finish_aggregate(*masked_prob_sums(logits, mask))


def real_or_fake(prediction: int) -> str:
    """ref: model/pred_func.py:134-135."""
    return {0: "REAL", 1: "FAKE"}[int(prediction) ^ 1]


DEFAULT_VERDICT = (0, 0.5)  # zero-face fallback (ref prediction.py:250-253)
