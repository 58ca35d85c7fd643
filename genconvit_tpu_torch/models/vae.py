"""GenConViT VAE branch, the original and the updated variant (port of
genconvit_tpu/models/vae.py:181-389).

Encoder 4x [conv3x3 s2 p1 -> BN -> LeakyReLU] (3->16->32->64->128), CHW
flatten, mu and var heads (25088 -> 12544 at 224 px). In training
(`train=True`) the BatchNorms take the batch's statistics and return the
new running ones, and the forward returns (logits, aux) with the
reconstruction, the KL term (KL_WEIGHT), mu, logvar and those statistics,
as vae_apply(train=True) returns them. With int8 heads
(`Encoder.quantize_heads_int8_`, models/vae.py:149-178 of the JAX
package) both heads hold per-output-column int8 weights and run through K3
(`matmul_wint8`).

variant='original' (ref model/genconvit_vae.py): quirk B4 of the reference
is kept: z = mu + eps * exp(0.5 * mu), sampling in eval too unless
sample=False, so scoring never computes the var head, which only feeds the
training KL term. Decoder: unflatten to (256, s, s), 4x [convT2x2 s2 ->
LeakyReLU] to 3 channels at half size. The backbone runs on x and on the
reconstruction in two calls (their sizes differ), then ReLU -> fc -> ReLU
-> fc2, or the SwiGLU head (head_act='swiglu', models/ed.py). Keys:
encoder.features.{0,3,6,9} (conv) / {1,4,7,10} (BN), encoder.mu/var,
decoder.features.{0,2,4,6}, convnext_backbone.*, fc, fc2.

variant='updated' (ref model/genconvit_vae_updated.py; the JAX package's
init_vae_updated / vae_updated_apply, :242-356): the correct
reparameterization z = mu + eps * exp(0.5 * logvar), so the var head runs
whenever it samples; decoder: decoder_input Linear (latent -> 128 s s) ->
unflatten (128, s, s) -> 3x [convT2x2 s2 -> BN -> LeakyReLU] -> convT2x2
s2 -> Tanh, at full size; the backbone runs on x and x_hat (resized where
the sizes differ) in one 2N call; ReLU -> fc -> ReLU -> fc2 (the
reference's dropouts are the identity in eval). In training it returns 4
encoder and then 3 decoder BN statistics. Keys as the original's except
decoder.decoder_input and decoder.features.{0,3,6,9} (convT) / {1,4,7}
(BN), the reference's Sequential indices.

Split over a mesh's 'model' axis (`tp`, parallel/mesh.split_module), each
latent head (float, or int8 through K3) holds a column block of its
output features; mu and logvar are gathered before `sample_z`, so that
eps, z and the KL term are drawn and computed as unsplit. The classifier
head splits as the ED's (models/ed.head); the updated variant's
decoder_input stays whole, as in the JAX package's rule.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from genconvit_tpu_torch.models.convnext import DEFAULT_PLAN, ConvNeXt
from genconvit_tpu_torch.models.ed import head, head_linears
from genconvit_tpu_torch.ops import collective as col
from genconvit_tpu_torch.ops.act import leaky_relu, relu, swiglu
from genconvit_tpu_torch.ops.conv import conv2d, conv_transpose2d
from genconvit_tpu_torch.ops.cuda.int8_matmul import matmul_wint8
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.ops.norm import batch_norm, batch_norm_train
from genconvit_tpu_torch.ops.quant import quantize_wint8
from genconvit_tpu_torch.ops.resize import resize_bilinear_torch

_ENC_CH = (3, 16, 32, 64, 128)
_DEC_CH = (256, 64, 32, 16, 3)
_UPD_CH = (128, 64, 32, 16, 3)
KL_WEIGHT = 0.5  # ref model/genconvit_vae.py:40
VARIANTS = ("original", "updated")

Stats = List[Tuple[torch.Tensor, torch.Tensor]]


class Int8Linear(nn.Module):
    """A Linear with weight-only int8: wq [N, K] int8 with per-output f32
    scales (`quantize_wint8` of the weight in its current dtype) and the
    f32 bias; the forward is K3 and returns x's dtype."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        wq, scale = quantize_wint8(linear.weight.detach(), dim=1)
        self.register_buffer("wq", wq)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", linear.bias.detach().float().contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_wint8(x, self.wq, self.scale, self.bias)


def _bn_act(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool, stats: Stats,
            group=None) -> torch.Tensor:
    """BatchNorm (batch statistics appended to `stats` in training; the
    global batch's over `group` under data parallelism) -> LeakyReLU."""
    if train:
        x, new = batch_norm_train(x, bn, group=group)
        stats.append(new)
    else:
        x = batch_norm(x, bn)
    return leaky_relu(x)


class Encoder(nn.Module):
    def __init__(self, flat: int, latent: int):
        super().__init__()
        layers = []
        for i in range(4):
            layers += [nn.Conv2d(_ENC_CH[i], _ENC_CH[i + 1], 3, 2, 1),
                       nn.BatchNorm2d(_ENC_CH[i + 1]), nn.LeakyReLU()]
        self.features = nn.Sequential(*layers)
        self.mu = nn.Linear(flat, latent)
        self.var = nn.Linear(flat, latent)
        self.latent = latent   # mu's width, whole also when the heads are split
        self.tp = None   # the 'model' axis when split

    def forward(self, x: torch.Tensor, train: bool = False, logvar: bool = False,
                bn_group=None):
        """[N,3,H,W] -> mu [N, latent]; with logvar, (mu, logvar); with
        train, (mu, logvar, the four BatchNorms' new running (mean, var)),
        the statistics over `bn_group`'s global batch where given."""
        stats: Stats = []
        for i in range(4):
            conv = self.features[3 * i]
            h = conv2d(x, conv.weight, conv.bias, stride=2, padding=1)
            x = _bn_act(h, self.features[3 * i + 1], train, stats, bn_group)
        # torch flattens in CHW order; flatten(1) of the channels_last
        # tensor gathers exactly that order
        flat = x.flatten(1)
        if train:
            if self.heads_int8:
                raise ValueError("training runs the float latent heads; int8 heads are "
                                 "an inference transform")
            return self._head(self.mu, flat), self._head(self.var, flat), stats
        if logvar:
            return self._head(self.mu, flat), self._head(self.var, flat)
        return self._head(self.mu, flat)

    def _head(self, head: nn.Module, flat: torch.Tensor) -> torch.Tensor:
        """A latent head; split, this rank's column block of it (K3 on the
        block's [latent / m, flat] int8 rows for int8 heads), gathered."""
        tp = self.tp
        if tp is not None:
            flat = col.copy_to_model(flat, tp.group)
        out = head(flat) if isinstance(head, Int8Linear) else F.linear(flat, head.weight,
                                                                       head.bias)
        return out if tp is None else col.gather_from_model(out, tp.group)

    @property
    def heads_int8(self) -> bool:
        return isinstance(self.mu, Int8Linear)

    @torch.no_grad()
    def quantize_heads_int8_(self) -> None:
        """Weight-only int8 for both latent heads, from their weights in the
        current dtype (quantize_latent_heads_int8 of the JAX package); the
        float weights are dropped, one head at a time."""
        if self.heads_int8:
            return
        self.mu = Int8Linear(self.mu)
        self.var = Int8Linear(self.var)


class Decoder(nn.Module):
    """The original variant's decoder."""

    def __init__(self):
        super().__init__()
        layers = []
        for i in range(4):
            layers += [nn.ConvTranspose2d(_DEC_CH[i], _DEC_CH[i + 1], 2, 2),
                       nn.LeakyReLU()]
        self.features = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor, train: bool = False,
                bn_group=None) -> Tuple[torch.Tensor, Stats]:
        """z [N, 256*s*s] -> ([N,3,16s,16s], no statistics)."""
        n, latent = z.shape
        s = int(round((latent / 256) ** 0.5))
        x = z.reshape(n, 256, s, s)
        for i in range(4):
            convt = self.features[2 * i]
            x = leaky_relu(conv_transpose2d(x, convt.weight, convt.bias, stride=2))
        return x, []


class UpdatedDecoder(nn.Module):
    """The updated variant's decoder (vae_updated_decode)."""

    def __init__(self, latent: int, s: int):
        super().__init__()
        self.decoder_input = nn.Linear(latent, _UPD_CH[0] * s * s)
        layers: List[nn.Module] = []
        for i in range(4):
            layers.append(nn.ConvTranspose2d(_UPD_CH[i], _UPD_CH[i + 1], 2, 2))
            layers += [nn.BatchNorm2d(_UPD_CH[i + 1]), nn.LeakyReLU()] if i < 3 else [nn.Tanh()]
        self.features = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor, train: bool = False,
                bn_group=None) -> Tuple[torch.Tensor, Stats]:
        """z [N, latent] -> ([N,3,16s,16s], with train the three BatchNorms'
        new running (mean, var), over `bn_group`'s global batch where
        given)."""
        h = F.linear(z, self.decoder_input.weight, self.decoder_input.bias)
        n = h.shape[0]
        s = int(round((h.shape[1] / _UPD_CH[0]) ** 0.5))
        x = h.reshape(n, _UPD_CH[0], s, s)
        stats: Stats = []
        for i in range(4):
            convt = self.features[3 * i]
            x = conv_transpose2d(x, convt.weight, convt.bias, stride=2)
            x = (_bn_act(x, self.features[3 * i + 1], train, stats, bn_group) if i < 3
                 else torch.tanh(x))
        return x, stats


class GenConViTVAE(nn.Module):
    def __init__(self, backbone: str = "convnext_tiny", img_size: int = 224,
                 latent_dims: Optional[int] = None, num_classes: int = 2,
                 backbone_classes: int = 1000, head_act: str = "default",
                 variant: str = "original"):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"vae variant must be one of {VARIANTS}, got {variant!r}")
        if variant == "updated" and head_act != "default":
            raise ValueError("the updated VAE variant has the reference's ReLU head only")
        flat = 128 * (img_size // 16) ** 2
        if latent_dims is None:
            latent_dims = 256 * (img_size // 32) ** 2
        self.variant, self.head_act = variant, head_act
        self.encoder = Encoder(flat, latent_dims)
        self.decoder = (UpdatedDecoder(latent_dims, img_size // 16) if variant == "updated"
                        else Decoder())
        self.convnext_backbone = ConvNeXt.from_name(backbone, backbone_classes)
        self.fc, self.fc2 = head_linears(head_act, 2 * backbone_classes, num_classes)
        self.tp = None   # the 'model' axis when split

    @property
    def updated(self) -> bool:
        return self.variant == "updated"

    @staticmethod
    def sample_z(mu: torch.Tensor, logvar: Optional[torch.Tensor] = None, *,
                 sample: bool = True, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z = mu + eps * exp(0.5 * logvar), or with quirk B4 (no logvar)
        exp(0.5 * mu); mu itself unless sample. eps is drawn from
        `generator` unless given."""
        if not sample:
            return mu
        if eps is None:
            if generator is None:
                raise ValueError("encode(sample=True) needs a generator or eps")
            eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                              dtype=torch.float32).to(mu.dtype)
        std = torch.exp(0.5 * (mu if logvar is None else logvar))
        return eps.to(mu.device, mu.dtype) * std + mu

    def encode(self, x: torch.Tensor, *, sample: bool = True,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z of the variant. eps is drawn from `generator` unless given."""
        if self.updated and sample:
            mu, logvar = self.encoder(x, logvar=True)
            return self.sample_z(mu, logvar, generator=generator, eps=eps)
        return self.sample_z(self.encoder(x), sample=sample, generator=generator, eps=eps)

    def _features(self, x: torch.Tensor, x_hat: torch.Tensor, plan: KernelPlan,
                  fresh: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x's features, x_hat's features, x_hat as the backbone read it):
        two backbone calls (original), or one 2N call on x and x_hat
        resized to x's size where they differ (updated)."""
        x_hat = x_hat.contiguous(memory_format=torch.channels_last)
        if not self.updated:
            return (self.convnext_backbone(x, plan, fresh),
                    self.convnext_backbone(x_hat, plan, fresh), x_hat)
        if x_hat.shape[2:] != x.shape[2:]:
            x_hat = resize_bilinear_torch(x_hat, (x.shape[2], x.shape[3]))
        both = torch.cat([x, x_hat], dim=0).contiguous(memory_format=torch.channels_last)
        feats = self.convnext_backbone(both, plan, fresh)
        n = x.shape[0]
        return feats[:n], feats[n:], x_hat

    def forward(self, x: torch.Tensor, plan: KernelPlan = DEFAULT_PLAN, *,
                sample: bool = True, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None, return_recon: bool = False,
                train: bool = False, per_call_folds: bool = False, bn_group=None):
        """x: [N,3,H,W] normalized -> logits [N, num_classes], and with
        return_recon the reconstruction at H x W (the original's resized,
        torchvision bilinear, antialias), which scoring never reads. train:
        the BatchNorms on batch statistics, the backbones' differentiable
        kernel paths, and (logits, aux) as vae_apply(train=True) returns
        them. per_call_folds alone: the backbones fold per call (an eval
        step during training). bn_group: in training, the process group whose
        global batch the BatchNorms' statistics cover (data parallelism)."""
        stats: Stats = []
        if train:
            mu, logvar, stats = self.encoder(x, train=True, bn_group=bn_group)
            z = self.sample_z(mu, logvar if self.updated else None, sample=sample,
                              generator=generator, eps=eps)
        else:
            z = self.encode(x, sample=sample, generator=generator, eps=eps)
        x_hat, dec_stats = self.decoder(z, train, bn_group)
        x1, x2, x_hat = self._features(x, x_hat, plan, train or per_call_folds)
        h = relu(torch.cat([x1, x2], dim=1))
        logits = head(h, self.fc, self.fc2, swiglu if self.head_act == "swiglu" else relu,
                      self.tp)
        if not (train or return_recon):
            return logits
        recon = x_hat if self.updated else resize_bilinear_torch(x_hat, (x.shape[2], x.shape[3]))
        if not train:
            return logits, recon
        kl = KL_WEIGHT * torch.mean(-0.5 * torch.sum(
            1.0 + logvar - mu.square() - torch.exp(logvar), dim=1))
        return logits, {"recon": recon, "kl": kl, "mu": mu, "logvar": logvar,
                        "bn_stats": stats + dec_stats}
