"""Prediction engine (port of the batched scoring path of
genconvit_tpu/infer/engine.py:42, 64-110, 165-177, 349-437, 866-874).

A uint8 face batch [V,F,S,S,3] with a [V,F] frame mask goes to the device
once; normalization, the ensemble and the masked per-video aggregation run
there. The Predictor runs on the GPU unless device="cpu" is passed: bfloat16
on CUDA (the kernel backbone), float32 on the CPU. The plan's int8 switches
(GENCONVIT_INT8_HEADS, GENCONVIT_INT8_MLP) apply as in the JAX engine
(infer/engine.py:223-237 there): the latent heads quantize after the dtype
cast, and the backbone folds follow plan.int8_mlp. GENCONVIT_PALLAS=1 or
stage selects the fused-block (K5) or fused-stage (K6) backbone, whose
weight packs are made at construction in place of the folds.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.config import Config
from genconvit_tpu_torch.data.preprocess import normalize_batch, pad_faces
from genconvit_tpu_torch.infer.aggregate import (DEFAULT_VERDICT,
                                                 aggregate_logits)
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.models.init import init_genconvit_
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan


def default_device() -> torch.device:
    """The GPU; without one this raises (pass device="cpu" to run there)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the Predictor runs on the GPU unless "
                           "device='cpu' is passed")
    return torch.device("cuda")


def default_compute_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


class Predictor:
    """params: None for a random init from `seed` on the device, or
    {'ed': state_dict, 'vae': state_dict} with the reference checkpoints'
    keys (core/convert.py makes them from the JAX package's trees)."""

    def __init__(self, config: Optional[Config] = None, *,
                 net: str = "genconvit", device: Any = None,
                 params: Optional[Mapping[str, Mapping[str, Any]]] = None,
                 seed: int = 0, deterministic_vae: bool = False,
                 kernel_plan: Optional[KernelPlan] = None,
                 dtype: Optional[torch.dtype] = None,
                 backbone_classes: int = 1000):
        self.config = config or Config()
        self.net = net
        self.device = torch.device(device) if device is not None else default_device()
        self.dtype = dtype or default_compute_dtype(self.device)
        self.kernel_plan = kernel_plan or KernelPlan.from_env()
        self.deterministic_vae = deterministic_vae
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        with torch.device("meta"):
            model = GenConViT(self.config, net, backbone_classes)
        model = model.to_empty(device=self.device)
        if params is None:
            init_genconvit_(model, self.generator)
        else:
            for name in ("ed", "vae"):
                if hasattr(model, name):
                    sd = {k: v if isinstance(v, torch.Tensor)
                          else torch.as_tensor(np.asarray(v))
                          for k, v in params[name].items()}
                    getattr(model, name).load_state_dict(sd, strict=True)
        # cast once (the latent heads alone are 630M parameters), then hold
        # every 4-D weight channels_last like the activations
        model = model.to(self.dtype).to(memory_format=torch.channels_last).eval()
        if self.kernel_plan.int8_heads:
            # after the cast, as the JAX engine does: the int8 weights come
            # from the weights the default path would multiply with
            model.quantize_heads_int8_()
        if self.dtype == torch.bfloat16:
            model.prepare_kernels(self.kernel_plan)  # K1/K4 folds or K5/K6 packs, from bf16
        self.model = model

    # ------------------------------------------------------------- forward

    @torch.inference_mode()
    def video_logits(self, frames_u8: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device tensors [V,F,S,S,3] uint8 and [V,F] -> per-video logits
        [V,K,2] and mask [V,K] (K = 2F for the ensemble, ED rows first)."""
        v, f = frames_u8.shape[:2]
        x = normalize_batch(frames_u8.reshape((v * f,) + frames_u8.shape[2:]),
                            self.dtype)
        logits = self.model(x, self.kernel_plan,
                            sample=not self.deterministic_vae,
                            generator=self.generator)
        if self.net == "genconvit":
            ed, vae = logits[: v * f], logits[v * f:]
            per_video = torch.cat([ed.reshape(v, f, 2), vae.reshape(v, f, 2)], dim=1)
            return per_video, torch.cat([mask, mask], dim=1)
        return logits.reshape(v, f, 2), mask

    @torch.inference_mode()
    def forward_batched(self, frames_u8: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident [V,F,S,S,3] uint8 + [V,F] -> device (y, y_val);
        no host sync (the benchmark loop's entry)."""
        return aggregate_logits(*self.video_logits(frames_u8, mask))

    # ------------------------------------------------------------- API

    def predict_videos_batched(self, faces_batch: np.ndarray, masks: np.ndarray
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """[V,F,S,S,3] uint8 + [V,F] -> (y [V] int64, y_val [V] float32)."""
        frames = torch.as_tensor(faces_batch).to(self.device, non_blocking=True)
        mask = torch.as_tensor(masks, dtype=torch.float32).to(self.device)
        y, y_val = self.forward_batched(frames, mask)
        return y.cpu().numpy(), y_val.cpu().numpy()

    def predict_faces(self, faces_u8: np.ndarray, num_frames: int) -> Tuple[int, float]:
        """faces_u8: [k,S,S,3] uint8, k in [0, num_frames]; zero faces give
        the reference's default verdict."""
        if len(faces_u8) == 0:
            return DEFAULT_VERDICT
        batch, mask = pad_faces(faces_u8, num_frames, self.config.img_size)
        y, y_val = self.predict_videos_batched(batch[None], mask[None])
        return int(y[0]), float(y_val[0])

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{'ed': ..., 'vae': ...} of the branches present, reference keys.
        Raises once the latent heads are int8: their float weights are gone."""
        if hasattr(self.model, "vae") and self.model.vae.encoder.heads_int8:
            raise RuntimeError("the VAE latent heads are int8 (int8_heads): the "
                               "branch no longer holds its float weights")
        return {name: getattr(self.model, name).state_dict()
                for name in ("ed", "vae") if hasattr(self.model, name)}
