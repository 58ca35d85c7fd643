"""Shared builders for the port's parity tests (this file holds no tests):
torch-oracle state dicts of the reference models at a small size, with
non-trivial layer scale and BatchNorm statistics, and the matching JAX
trees through the JAX package's converter."""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn as nn

from genconvit_tpu.core import convert

from tests.torch_oracles import (ConvNeXtOracle, EDDecoderOracle,
                                 EDEncoderOracle, VAEDecoderOracle,
                                 VAEEncoderOracle)

SMALL_DEPTHS = (1, 1, 1, 1)
SMALL_DIMS = (8, 16, 32, 64)
SMALL_NAME = "convnext_test"
IMG = 64
BACKBONE_CLASSES = 10


@pytest.fixture
def small_backbone(monkeypatch):
    """Register the small ConvNeXt under a name the port's configs accept."""
    from genconvit_tpu_torch.models import convnext as port_convnext

    monkeypatch.setitem(port_convnext.CONVNEXT_CFGS, SMALL_NAME,
                        dict(depths=SMALL_DEPTHS, dims=SMALL_DIMS))
    return SMALL_NAME


def _prefixed(sd, prefix, module):
    sd.update({f"{prefix}{k}": v.detach().clone()
               for k, v in module.state_dict().items()})


def convnext_oracle(seed, rng, num_classes=BACKBONE_CLASSES):
    """Small ConvNeXt oracle with layer scale U(0.1, 1): the 1e-6 init
    would make block parity nearly vacuous."""
    torch.manual_seed(seed)
    bb = ConvNeXtOracle(depths=SMALL_DEPTHS, dims=SMALL_DIMS,
                        num_classes=num_classes).eval()
    with torch.no_grad():
        for name, p in bb.named_parameters():
            if name.endswith("gamma"):
                p.copy_(torch.from_numpy(
                    rng.uniform(0.1, 1.0, p.shape).astype(np.float32)))
    return bb


def _head(sd, num_classes, backbone_classes):
    nf = 2 * backbone_classes
    _prefixed(sd, "fc.", nn.Linear(nf, nf // 4))
    _prefixed(sd, "fc2.", nn.Linear(nf // 4, num_classes))


def ed_state_dict(seed, rng, backbone_classes=BACKBONE_CLASSES):
    bb = convnext_oracle(seed, rng, backbone_classes)
    sd = {}
    _prefixed(sd, "encoder.", EDEncoderOracle())
    _prefixed(sd, "decoder.", EDDecoderOracle())
    _prefixed(sd, "backbone.", bb)
    _head(sd, 2, backbone_classes)
    return sd


def vae_state_dict(seed, rng, backbone_classes=BACKBONE_CLASSES, img=IMG):
    bb = convnext_oracle(seed, rng, backbone_classes)
    enc = VAEEncoderOracle(img_size=img)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    sd = {}
    _prefixed(sd, "encoder.", enc)
    _prefixed(sd, "decoder.", VAEDecoderOracle(s=img // 32))
    _prefixed(sd, "convnext_backbone.", bb)
    _head(sd, 2, backbone_classes)
    return sd


def jax_trees(sd_ed, sd_vae):
    """The JAX package's trees for the oracle state dicts."""
    return {"ed": convert.convert_ed(sd_ed),
            "vae": convert.convert_vae(sd_vae, carry_dead_params=False)}


def images(rng, n=2, img=IMG):
    """(NCHW float32 numpy, the port's channels_last tensor, JAX NHWC)."""
    x = rng.standard_normal((n, 3, img, img), dtype=np.float32)
    t = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    return x, t, np.ascontiguousarray(x.transpose(0, 2, 3, 1))


@contextlib.contextmanager
def small_backbone_registered():
    """small_backbone for fixtures wider than one test."""
    from genconvit_tpu_torch.models import convnext as port_convnext

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_convnext.CONVNEXT_CFGS, SMALL_NAME,
                   dict(depths=SMALL_DEPTHS, dims=SMALL_DIMS))
        yield SMALL_NAME


def write_gcv_weights(wdir, seed=0, head_scale=10.0):
    """The ED and VAE `.gcv` files of the small oracle models, written by the
    JAX package's save_checkpoint and nested as train_model nests them, both
    heads' last layer scaled by `head_scale` so that verdicts are decisive."""
    from genconvit_tpu.core import checkpoint as jax_ckpt

    rng = np.random.default_rng(seed)
    sd_ed, sd_vae = ed_state_dict(seed, rng), vae_state_dict(seed + 1, rng)
    for sd in (sd_ed, sd_vae):
        sd["fc2.weight"] *= head_scale
        sd["fc2.bias"] *= head_scale
    trees = jax_trees(sd_ed, sd_vae)
    wdir.mkdir(parents=True, exist_ok=True)
    jax_ckpt.save_checkpoint(str(wdir / "genconvit_ed_inference.gcv"), {"ed": trees["ed"]})
    jax_ckpt.save_checkpoint(str(wdir / "genconvit_vae_inference.gcv"), {"vae": trees["vae"]})


def write_small_config(path):
    """A model/config.yaml both packages read (load_config): the small
    backbone at IMG px."""
    path.write_text(f"model:\n  backbone: {SMALL_NAME}\n  latent_dims: {256 * (IMG // 32) ** 2}\n"
                    f"img_size: {IMG}\nnum_classes: 2\n")
    return str(path)


class InMemoryDecoder:
    """A stand-in for the native decoder's Python face (`native_available`,
    `NativeVideoReader`, `decode_videos_batch`) that serves videos from
    memory by file name: each video's RGB frames [n,S,S,3] and YUV420
    planes at the model size S, with its (space, full_range). A name it
    does not hold cannot be opened (IOError; count 0 in a batch decode).
    `install` swaps it into data.native modules (the port's, the JAX
    package's) for the life of a MonkeyPatch, so that the fullframe drivers
    run where the library cannot be built."""

    def __init__(self, videos):
        self.videos = videos   # name -> (rgb, (y, u, v), (space, full_range))
        self.opened = []       # (name, out_size) of every reader opened

    @classmethod
    def seeded(cls, seed, size, frame_counts, color=(("bt601", False), ("bt709", True))):
        """Videos 'm{i}.mp4' with frame_counts[i] frames (0: a video without
        frames) of seeded planes; the RGB frames are the planes converted by
        the port's yuv420_to_rgb and rounded."""
        from genconvit_tpu_torch.data.preprocess import yuv420_to_rgb, yuv_affine

        rng = np.random.default_rng(seed)
        videos = {}
        for i, n in enumerate(frame_counts):
            space, full = color[i % len(color)]
            base = rng.integers(16, 236, (1, size, size), np.uint8)
            y = np.clip(base.astype(np.int32) + rng.integers(-20, 21, (n, size, size)),
                        0, 255).astype(np.uint8)
            u = rng.integers(64, 192, (n, size // 2, size // 2), np.uint8)
            v = rng.integers(64, 192, (n, size // 2, size // 2), np.uint8)
            rgb = yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v),
                                yuv_affine(space, full)).round().to(torch.uint8).numpy()
            videos[f"m{i}.mp4"] = (rgb, (y, u, v), (space, full))
        return cls(videos)

    def _video(self, path):
        import os

        name = os.path.basename(path)
        if name not in self.videos:
            raise IOError(f"cannot open video: {path}")
        return self.videos[name]

    def reader(self, path, out_size=None):
        rgb, planes, color = self._video(path)
        size = rgb.shape[1:3] if len(rgb) else planes[0].shape[1:3]
        assert out_size is None or tuple(out_size) == tuple(size)[::-1], (out_size, size)
        self.opened.append((path, out_size))
        return _MemoryReader(path, rgb, planes, color)

    def decode_batch(self, paths, frames_per_video, out_w, out_h, threads=0):
        from genconvit_tpu_torch.data.frames import sample_frame_indices

        out = np.zeros((len(paths), frames_per_video, out_h, out_w, 3), np.uint8)
        counts = np.zeros((len(paths),), np.int64)
        for i, p in enumerate(paths):
            try:
                rgb = self._video(p)[0]
            except IOError:
                continue
            got = rgb[sample_frame_indices(len(rgb), frames_per_video)]
            out[i, : len(got)] = got
            counts[i] = len(got)
        return out, counts

    def install(self, mp, *modules):
        for m in modules:
            mp.setattr(m, "native_available", lambda: True)
            mp.setattr(m, "NativeVideoReader", self.reader)
            mp.setattr(m, "decode_videos_batch", self.decode_batch)


class _MemoryReader:
    def __init__(self, path, rgb, planes, color):
        self.path, self._rgb, self._planes, self._color = path, rgb, planes, color
        self.num_frames = len(rgb)

    def __len__(self):
        return self.num_frames

    def read_frames(self, indices):
        return self._rgb[list(indices)]

    def read_frames_yuv(self, indices):
        return tuple(p[list(indices)] for p in self._planes)

    def color_info(self):
        return self._color

    def close(self):
        pass


def seeded_faces(seed, n):
    """n RGB uint8 face crops, 90-199 px a side: a skin-toned ellipse with two
    dark eyes on a noisy background (numpy only)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(90, 200, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        img = rng.integers(30, 90, (h, w, 3)).astype(np.float32)
        cy, cx = h / 2 + rng.uniform(-5, 5), w / 2 + rng.uniform(-5, 5)
        inside = ((yy - cy) / (0.45 * h)) ** 2 + ((xx - cx) / (0.38 * w)) ** 2 < 1
        img[inside] = np.array([200, 160, 140]) + rng.uniform(-25, 25, 3) \
            + rng.normal(0, 8, (inside.sum(), 3))
        for ex in (-0.15, 0.15):
            eye = (((yy - cy + 0.1 * h) / (0.05 * h)) ** 2
                   + ((xx - cx - ex * w) / (0.08 * w)) ** 2 < 1)
            img[eye] = (40, 30, 30)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def seeded_frames(seed, n):
    """n RGB uint8 video-like frames (180x320, 240x240, 360x640 in turn):
    16-px blocks of colour leaning away from skin, noise, and up to two
    skin-coloured discs, so that the skin veto and weak labels go both ways."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = ((180, 320), (240, 240), (360, 640))[i % 3]
        yy, xx = np.mgrid[0:h, 0:w]
        base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
        base[..., 2] = np.maximum(base[..., 2], base[..., 0] + 40)
        img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w] * 0.6 \
            + rng.normal(0, 10, (h, w, 3))
        for _ in range(int(rng.integers(0, 3))):
            r = rng.uniform(0.08, 0.25) * min(h, w)
            cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[disc] = np.array([205, 150, 125]) + rng.normal(0, 6, (disc.sum(), 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out
