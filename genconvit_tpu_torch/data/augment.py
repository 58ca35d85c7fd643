"""Training augmentation (port of genconvit_tpu/data/augment.py): the
reference's albumentations strong_aug pipeline (ref dataset/loader.py:24-60)
re-implemented on numpy/cv2 with the same ops and probabilities:

  Compose(p=0.9)[ RandomRotate90(0.2), Transpose(0.2), HFlip(0.5), VFlip(0.5),
                  OneOf[GaussNoise](0.2), ShiftScaleRotate(0.2),
                  OneOf[CLAHE(2), Sharpen, Emboss, RandomBrightnessContrast](0.2),
                  HueSaturationValue(0.2) ]

Parameter ranges follow albumentations 1.3 defaults. Host-side (uint8 in/out),
applied per image before the device-side normalize. The random draws are
made first (`_draws`, in the JAX package's order) and the image work after,
so that `skip_aug` can advance the generator past an image it never reads.
"""

from __future__ import annotations

import numpy as np


def _rot90(img: np.ndarray, k: int) -> np.ndarray:
    return np.rot90(img, k=k).copy()


def _transpose(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img.transpose(1, 0, 2))


def _hflip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1].copy()


def _vflip(img: np.ndarray) -> np.ndarray:
    return img[::-1].copy()


def _shift_scale_rotate_draw(rng, shape):
    h, w = shape[:2]
    angle = rng.uniform(-45, 45)
    scale = 1.0 + rng.uniform(-0.1, 0.1)
    dx = rng.uniform(-0.0625, 0.0625) * w
    dy = rng.uniform(-0.0625, 0.0625) * h
    return angle, scale, dx, dy


def _shift_scale_rotate(img: np.ndarray, angle, scale, dx, dy) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
    m[0, 2] += dx
    m[1, 2] += dy
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT_101)


def _gauss_noise_draw(rng, shape):
    var = rng.uniform(10.0, 50.0)
    return (rng.normal(0, var ** 0.5, shape),)


def _gauss_noise(img: np.ndarray, noise: np.ndarray) -> np.ndarray:
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _clahe(img: np.ndarray) -> np.ndarray:
    import cv2

    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    lab[..., 0] = clahe.apply(lab[..., 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


def _sharpen_draw(rng, shape):
    return rng.uniform(0.2, 0.5), rng.uniform(0.5, 1.0)   # alpha, lightness


def _sharpen(img: np.ndarray, alpha, lightness) -> np.ndarray:
    import cv2

    laplacian = np.array([[-1, -1, -1], [-1, 8 + lightness, -1], [-1, -1, -1]],
                         dtype=np.float32)
    sharp = cv2.filter2D(img.astype(np.float32), -1, laplacian)
    out = (1 - alpha) * img.astype(np.float32) + alpha * sharp
    return np.clip(out, 0, 255).astype(np.uint8)


def _emboss_draw(rng, shape):
    return rng.uniform(0.2, 0.5), rng.uniform(0.2, 0.7)   # alpha, strength


def _emboss(img: np.ndarray, alpha, strength) -> np.ndarray:
    import cv2

    kernel = np.array([[-1 - strength, -strength, 0],
                       [-strength, 1, strength],
                       [0, strength, 1 + strength]], dtype=np.float32)
    emb = cv2.filter2D(img.astype(np.float32), -1, kernel)
    out = (1 - alpha) * img.astype(np.float32) + alpha * emb
    return np.clip(out, 0, 255).astype(np.uint8)


def _brightness_contrast_draw(rng, shape):
    return rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2)   # brightness, contrast


def _brightness_contrast(img: np.ndarray, brightness, contrast) -> np.ndarray:
    out = img.astype(np.float32) * (1.0 + contrast) + 255.0 * brightness
    return np.clip(out, 0, 255).astype(np.uint8)


def _hue_saturation_value_draw(rng, shape):
    return rng.uniform(-20, 20), rng.uniform(-30, 30), rng.uniform(-20, 20)


def _hue_saturation_value(img: np.ndarray, hue, sat, val) -> np.ndarray:
    import cv2

    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + int(hue * 179 / 360)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + sat, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + val, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def _no_draw(rng, shape):
    return ()


_ONE_OF = ((_no_draw, _clahe), (_sharpen_draw, _sharpen), (_emboss_draw, _emboss),
           (_brightness_contrast_draw, _brightness_contrast))


def _draws(rng: np.random.Generator, shape, p: float):
    """The pipeline's random draws for an image of `shape` (H, W, C), in
    the order strong_aug makes them: the ops to apply, each (fn, args)."""
    ops = []
    if rng.random() >= p:
        return ops
    h, w, c = shape
    if rng.random() < 0.2:  # RandomRotate90
        k = int(rng.integers(1, 4))
        ops.append((_rot90, (k,)))
        if k % 2:
            h, w = w, h
    if rng.random() < 0.2:  # Transpose
        ops.append((_transpose, ()))
        h, w = w, h
    if rng.random() < 0.5:  # HorizontalFlip
        ops.append((_hflip, ()))
    if rng.random() < 0.5:  # VerticalFlip
        ops.append((_vflip, ()))
    if rng.random() < 0.2:  # OneOf[GaussNoise]
        ops.append((_gauss_noise, _gauss_noise_draw(rng, (h, w, c))))
    if rng.random() < 0.2:  # ShiftScaleRotate
        ops.append((_shift_scale_rotate, _shift_scale_rotate_draw(rng, (h, w, c))))
    if rng.random() < 0.2:  # OneOf[CLAHE, Sharpen, Emboss, BrightnessContrast]
        draw, fn = _ONE_OF[int(rng.integers(0, 4))]
        ops.append((fn, draw(rng, (h, w, c))))
    if rng.random() < 0.2:  # HueSaturationValue
        ops.append((_hue_saturation_value, _hue_saturation_value_draw(rng, (h, w, c))))
    return ops


def strong_aug(img: np.ndarray, rng: np.random.Generator,
               p: float = 0.9) -> np.ndarray:
    """One image through the pipeline. uint8 HWC in/out."""
    for fn, args in _draws(rng, img.shape, p):
        img = fn(img, *args)
    return img


def skip_aug(shape, rng: np.random.Generator, p: float = 0.9) -> None:
    """Advance rng exactly as strong_aug of an image of `shape` (H, W, C)
    would, without the image: the draws alone (a data-parallel rank's
    view of another rank's row)."""
    _draws(rng, shape, p)
