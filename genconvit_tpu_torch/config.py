"""Model configuration (port of genconvit_tpu/config.py:20-120): the fields
the scoring path, the drivers and training read, as plain dataclasses.

`load_config` reads the reference's `model/config.yaml` with a reader of
this module's own (`parse_yaml`): the block-mapping subset that file uses
(nested `key: value` maps by indentation, comments; null, bools, decimal
ints, floats and strings resolved as PyYAML's safe loader resolves them),
without importing yaml.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional, Tuple

_DEFAULT_IMG_SIZE = 224
_DEFAULT_LATENT = 12544  # == 256 * (224 // 32) ** 2 (ref model/genconvit_vae.py:83)


@dataclasses.dataclass
class ModelConfig:
    backbone: str = "convnext_tiny"
    embedder: str = "swin_tiny_patch4_window7_224"
    latent_dims: int = _DEFAULT_LATENT
    # 'original' | 'updated' (ref model/genconvit_vae_updated.py); the port
    # has the original variant only
    vae_variant: str = "original"

    def __post_init__(self):
        if self.vae_variant != "original":
            raise NotImplementedError(
                f"vae_variant={self.vae_variant!r}: the updated VAE variant is not "
                "ported yet (genconvit_tpu/models/vae.py vae_updated_apply)")


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    # training (ref model/config.yaml; genconvit_tpu/config.py:49-55)
    batch_size: int = 32
    epoch: int = 1
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    num_classes: int = 2
    img_size: int = _DEFAULT_IMG_SIZE
    min_val_loss: float = 10000.0
    # 'float32' picks the device's default (bfloat16 on CUDA, float32 on
    # the CPU); 'bfloat16' asks for it anywhere
    compute_dtype: str = "float32"
    # 'hybrid' | 'jax' (the on-device detector) | 'haar' | 'skin' |
    # 'fullframe' | 'center' | 'recorded' | 'none'; the Predictor walks
    # hybrid -> jax -> haar -> fullframe where a detector's artifacts are
    # missing (genconvit_tpu/config.py:56-66)
    face_backend: str = "hybrid"
    weight_dir: str = "weight"

    def derived_latent_dims(self) -> int:
        """latent_dims consistent with the VAE decoder's (256, s, s)
        unflatten, s = img_size // 32; used when img_size != 224."""
        s = self.img_size // 32
        return 256 * s * s

    def vae_latent_dims(self) -> int:
        """Width of the VAE mu/var heads: the explicit latent_dims at 224 px,
        the derived one otherwise (genconvit_tpu/models/genconvit.py:28-40)."""
        return (self.model.latent_dims if self.img_size == 224
                else self.derived_latent_dims())

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        """Unknown keys are ignored, as in the JAX package."""
        d = dict(d)
        md = d.pop("model", {}) or {}
        known_m = {f.name for f in dataclasses.fields(ModelConfig)}
        model = ModelConfig(**{k: v for k, v in md.items() if k in known_m})
        known = {f.name for f in dataclasses.fields(Config)} - {"model"}
        return Config(model=model, **{k: v for k, v in d.items() if k in known})


# ------------------------------------------------------------------ YAML

_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)([eE][-+][0-9]+)?$")


def _scalar(text: str) -> Any:
    """A plain or quoted scalar of the reference's config.yaml as PyYAML's
    SafeLoader resolves it: null, bools, decimal ints, floats (YAML 1.1:
    '1e-4' without a dot stays a string there, so it does here) and
    strings. Escapes in double quotes raise ValueError."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise ValueError(f"escape sequences are not supported: {text!r}")
        return body
    low = text.lower()
    if text in ("", "~") or low == "null" and text in ("null", "Null", "NULL"):
        return None
    if low in _BOOL and text in (low, low.capitalize(), low.upper()):
        return _BOOL[low]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Dict[str, Any]:
    """Nested block mappings of scalars. Anything else (sequences, flow
    collections, anchors, multi-line scalars) raises ValueError."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"tab in indentation: {raw!r}")
        lines.append((len(line) - len(line.lstrip()), line.strip()))
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = [(-1, root)]
    for i, (indent, body) in enumerate(lines):
        key, sep, value = body.partition(":")
        if not sep or (value and not value.startswith((" ", "\t"))) or body[0] in "-[{&*!|>":
            raise ValueError(f"not a block-mapping line: {body!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        key, value = _scalar(key.strip()), value.strip()
        if value:
            if value[0] in "[{&*!|>":
                raise ValueError(f"unsupported YAML value: {value!r}")
            parent[key] = _scalar(value)
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            parent[key] = {}
            stack.append((indent, parent[key]))
        else:
            parent[key] = None
    return root


def load_config(path: Optional[str] = None) -> Config:
    """The first file of: path, $GENCONVIT_CONFIG, ./model/config.yaml (the
    reference's layout), ./config.yaml; the defaults (the reference's
    model/config.yaml values) when none exists."""
    for c in (path, os.environ.get("GENCONVIT_CONFIG"),
              os.path.join("model", "config.yaml"), "config.yaml"):
        if c and os.path.isfile(c):
            with open(c) as f:
                return Config.from_dict(parse_yaml(f.read()) or {})
    return Config()


def apply_size(config: Config, size: str) -> Config:
    """The --s tiny|large backbone rewrite (ref prediction.py:314-318)."""
    if size in ("tiny", "large"):
        config.model.backbone = f"convnext_{size}"
        config.model.embedder = f"swin_{size}_patch4_window7_224"
    return config
