"""The one general generator: it turns a traffic mix's parameters and a seed
into inputs. Every seed gets the same sizes and the same gaps between
arrivals; the seed picks their order and the pixels, so that the work of a
run does not depend on its seed.

Parameters read (absent ones do not apply):
  videos_per_batch, pool_batches, masked_share      scoring batches
  uploads, full_share, partial_frames [lo, hi]      served uploads
  burst_on_s, burst_off_s                           on/off arrivals (else Poisson)
  batch, pool_batches                               training batches
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

IMAGE_CHUNK = 256   # images drawn a call
FIELD_SIZES = (2, 4, 7, 14, 28, 56)   # colour-field cells a side, image by image


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed and a tag."""
    entropy = [int(seed) % (1 << 64)] + [ord(c) for c in tag]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))


def pixels(n: int, shape: Tuple[int, ...], seed: int, tag: str, device) -> np.ndarray:
    """n host uint8 image stacks of `shape` (..., S, S, 3), drawn on the
    device and copied back: [n, *shape]. Each image is a random colour field
    at one of FIELD_SIZES cells a side (image i takes the i-th, cyclically:
    the same mix for every seed), bilinearly upsampled, with uniform noise
    and a contrast of its own, so that images differ in their structure and
    their global statistics and not only in their noise."""
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(derive(seed, tag))
    s = shape[-2]
    count = n * int(np.prod(shape[:-3], dtype=np.int64))
    out = torch.empty((count, s, s, 3), dtype=torch.uint8, device=device)
    for a in range(0, count, IMAGE_CHUNK):
        k = min(IMAGE_CHUNK, count - a)
        base = torch.empty((k, 3, s, s), device=device)
        for j, cells in enumerate(FIELD_SIZES):
            idx = torch.arange(j, k, len(FIELD_SIZES), device=device)
            if len(idx):
                low = torch.rand((len(idx), 3, cells, cells), generator=g, device=device)
                base[idx] = F.interpolate(low, size=(s, s), mode="bilinear", align_corners=False)
        contrast = torch.rand((k, 1, 1, 1), generator=g, device=device) * 1.5 + 0.25
        level = torch.rand((k, 3, 1, 1), generator=g, device=device) * 160.0 + 48.0
        amp = torch.rand((k, 1, 1, 1), generator=g, device=device) * 80.0
        noise = (torch.rand((k, 3, s, s), generator=g, device=device) * 2.0 - 1.0) * amp
        img = level + (base - 0.5) * 255.0 * contrast + noise
        out[a:a + k] = img.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1)
    return out.reshape((n,) + tuple(shape)).cpu().numpy()


def frame_masks(n: int, v: int, f: int, masked_share: float, seed: int) -> np.ndarray:
    """[n, v, f] float32 masks with round(masked_share * n * v * f) frames off,
    spread by the seed; every video keeps at least one frame."""
    total = n * v * f
    off = int(round(masked_share * total))
    r = rng(seed, "masks")
    flat = np.ones(total, np.float32)
    order = r.permutation(total)
    # the first frame of each video never goes off
    keep = (order % f) == 0
    flat[order[~keep][:off]] = 0.0
    return flat.reshape(n, v, f)


def score_pool(mix: dict, cfg: dict, seed: int, device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """`pool_batches` distinct ([V,F,S,S,3] uint8, [V,F] mask) host batches."""
    n, v, f, s = mix["pool_batches"], mix["videos_per_batch"], cfg["num_frames"], cfg["img_size"]
    frames = pixels(n, (v, f, s, s, 3), seed, "score_frames", device)
    masks = frame_masks(n, v, f, mix["masked_share"], seed)
    return [(frames[i], masks[i]) for i in range(n)]


def _blocks(count: int, block: int) -> list:
    return [(a, min(count, a + block)) for a in range(0, count, block)]


def exponential_gaps(count: int, rate: float, seed: int) -> np.ndarray:
    """`count` gaps between arrivals (mean 1 / rate): in every block of about
    a second's arrivals, the exponential distribution's quantiles at
    (i + 0.5) / n, in an order drawn from the seed. Poisson arrivals whose
    gaps, and whose count in every second, are the same for every seed."""
    r = rng(seed, "gaps")
    out = np.empty(count)
    for a, b in _blocks(count, max(1, int(round(rate)))):
        q = (np.arange(b - a) + 0.5) / (b - a)
        out[a:b] = r.permutation(-np.log1p(-q) / rate)
    return out


def upload_frames(count: int, mix: dict, cfg: dict, seed: int, block: int) -> np.ndarray:
    """Faces per upload: in every block, full_share of them num_frames, the
    rest cycling through partial_frames [lo, hi], in an order drawn from the
    seed."""
    f = cfg["num_frames"]
    lo, hi = mix["partial_frames"]
    r = rng(seed, "frames")
    out = np.empty(count, np.int64)
    k = 0
    for a, b in _blocks(count, block):
        full = int(round(mix["full_share"] * (b - a)))
        partial = [lo + (k + i) % (hi - lo + 1) for i in range(b - a - full)]
        k += len(partial)
        out[a:b] = r.permutation(np.array([f] * full + partial, np.int64))
    return out


def arrivals(count: int, rate: float, seed: int, on_s: float = 0.0, off_s: float = 0.0
             ) -> np.ndarray:
    """Due times [s] of `count` requests at a mean of `rate` a second, the
    first at 0. Poisson (`exponential_gaps`) where on_s is 0; otherwise
    on/off: Poisson at rate * (on_s + off_s) / on_s through each on phase of
    on_s seconds, none through the off_s seconds after it."""
    peak = rate * (on_s + off_s) / on_s if on_s else rate
    due = np.cumsum(exponential_gaps(count, peak, seed))
    due -= due[0]
    return due + np.floor(due / on_s) * off_s if on_s else due


def serve_schedule(mix: dict, cfg: dict, rate: float, seconds: float, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(due times from the window's start [s], faces per upload, the pool
    upload each request sends): round(rate * seconds) requests, arriving as
    the mix's burst_on_s and burst_off_s say (absent: Poisson)."""
    count = max(1, int(round(rate * seconds)))
    due = arrivals(count, rate, seed, mix.get("burst_on_s", 0.0), mix.get("burst_off_s", 0.0))
    frames = upload_frames(count, mix, cfg, seed, max(1, int(round(rate))))
    which = np.arange(count) % mix["uploads"]
    return due, frames, rng(seed, "which").permutation(which)


def upload_pool(mix: dict, cfg: dict, seed: int, device) -> np.ndarray:
    """`uploads` distinct host face stacks [uploads, F, S, S, 3] uint8."""
    f, s = cfg["num_frames"], cfg["img_size"]
    return pixels(mix["uploads"], (f, s, s, 3), seed, "upload_frames", device)


def train_pool(mix: dict, cfg: dict, seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """`pool_batches` distinct host batches: images [P, B, S, S, 3] uint8 and
    labels [P, B] int64, half of each batch of each class."""
    p, b, s = mix["pool_batches"], mix["batch"], cfg["img_size"]
    images = pixels(p, (b, s, s, 3), seed, "train_images", device)
    r = rng(seed, "labels")
    base = np.arange(b) % 2
    labels = np.stack([r.permutation(base) for _ in range(p)]).astype(np.int64)
    return images, labels
