"""Training augmentation (copy of genconvit_tpu/data/augment.py): the
reference's albumentations strong_aug pipeline (ref dataset/loader.py:24-60)
re-implemented on numpy/cv2 with the same ops and probabilities:

  Compose(p=0.9)[ RandomRotate90(0.2), Transpose(0.2), HFlip(0.5), VFlip(0.5),
                  OneOf[GaussNoise](0.2), ShiftScaleRotate(0.2),
                  OneOf[CLAHE(2), Sharpen, Emboss, RandomBrightnessContrast](0.2),
                  HueSaturationValue(0.2) ]

Parameter ranges follow albumentations 1.3 defaults. Host-side (uint8 in/out),
applied per image before the device-side normalize.
"""

from __future__ import annotations

import numpy as np


def _shift_scale_rotate(img: np.ndarray, rng) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    angle = rng.uniform(-45, 45)
    scale = 1.0 + rng.uniform(-0.1, 0.1)
    dx = rng.uniform(-0.0625, 0.0625) * w
    dy = rng.uniform(-0.0625, 0.0625) * h
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
    m[0, 2] += dx
    m[1, 2] += dy
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT_101)


def _gauss_noise(img: np.ndarray, rng) -> np.ndarray:
    var = rng.uniform(10.0, 50.0)
    noise = rng.normal(0, var ** 0.5, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _clahe(img: np.ndarray, rng) -> np.ndarray:
    import cv2

    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    lab[..., 0] = clahe.apply(lab[..., 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


def _sharpen(img: np.ndarray, rng) -> np.ndarray:
    import cv2

    alpha = rng.uniform(0.2, 0.5)
    lightness = rng.uniform(0.5, 1.0)
    laplacian = np.array([[-1, -1, -1], [-1, 8 + lightness, -1], [-1, -1, -1]],
                         dtype=np.float32)
    sharp = cv2.filter2D(img.astype(np.float32), -1, laplacian)
    out = (1 - alpha) * img.astype(np.float32) + alpha * sharp
    return np.clip(out, 0, 255).astype(np.uint8)


def _emboss(img: np.ndarray, rng) -> np.ndarray:
    import cv2

    alpha = rng.uniform(0.2, 0.5)
    strength = rng.uniform(0.2, 0.7)
    kernel = np.array([[-1 - strength, -strength, 0],
                       [-strength, 1, strength],
                       [0, strength, 1 + strength]], dtype=np.float32)
    emb = cv2.filter2D(img.astype(np.float32), -1, kernel)
    out = (1 - alpha) * img.astype(np.float32) + alpha * emb
    return np.clip(out, 0, 255).astype(np.uint8)


def _brightness_contrast(img: np.ndarray, rng) -> np.ndarray:
    brightness = rng.uniform(-0.2, 0.2)
    contrast = rng.uniform(-0.2, 0.2)
    out = img.astype(np.float32) * (1.0 + contrast) + 255.0 * brightness
    return np.clip(out, 0, 255).astype(np.uint8)


def _hue_saturation_value(img: np.ndarray, rng) -> np.ndarray:
    import cv2

    hue = rng.uniform(-20, 20)
    sat = rng.uniform(-30, 30)
    val = rng.uniform(-20, 20)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + int(hue * 179 / 360)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + sat, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + val, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def strong_aug(img: np.ndarray, rng: np.random.Generator,
               p: float = 0.9) -> np.ndarray:
    """One image through the pipeline. uint8 HWC in/out."""
    if rng.random() >= p:
        return img
    if rng.random() < 0.2:  # RandomRotate90
        img = np.rot90(img, k=int(rng.integers(1, 4))).copy()
    if rng.random() < 0.2:  # Transpose
        img = np.ascontiguousarray(img.transpose(1, 0, 2))
    if rng.random() < 0.5:  # HorizontalFlip
        img = img[:, ::-1].copy()
    if rng.random() < 0.5:  # VerticalFlip
        img = img[::-1].copy()
    if rng.random() < 0.2:  # OneOf[GaussNoise]
        img = _gauss_noise(img, rng)
    if rng.random() < 0.2:  # ShiftScaleRotate
        img = _shift_scale_rotate(img, rng)
    if rng.random() < 0.2:  # OneOf[CLAHE, Sharpen, Emboss, BrightnessContrast]
        img = [_clahe, _sharpen, _emboss, _brightness_contrast][
            int(rng.integers(0, 4))](img, rng)
    if rng.random() < 0.2:  # HueSaturationValue
        img = _hue_saturation_value(img, rng)
    return img
