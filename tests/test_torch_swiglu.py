"""The port's SwiGLU classifier heads (models/ed.py head_act='swiglu', the
JAX package's research head, picked by fc's width) against the JAX
package's on the CPU: the ED and the original VAE from `init_ed` /
`init_vae(head_act='swiglu')` trees (layer scale U(0.1, 1)) against
`ed_apply` / `vae_apply` in float32 (rtol 1e-4, atol 1e-5), `swiglu`
itself against the JAX op, and the Predictor building both heads from
`.gcv` files the JAX package wrote and scoring as `genconvit_apply` does
(y equal, y_val within 1e-5). Small models: ConvNeXt depths (1,1,1,1),
dims (8..64), 64 px."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genconvit_tpu.core import checkpoint as jax_ckpt
from genconvit_tpu.data import preprocess as jax_pre
from genconvit_tpu.infer import aggregate as jax_agg
from genconvit_tpu.models import convnext as jax_convnext
from genconvit_tpu.models.ed import ed_apply, init_ed
from genconvit_tpu.models.genconvit import genconvit_apply
from genconvit_tpu.models.vae import init_vae, vae_apply
from genconvit_tpu.ops.act import swiglu as jax_swiglu

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core.convert import branch_spec, state_dict_from_jax
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.models.ed import GenConViTED
from genconvit_tpu_torch.models.vae import GenConViTVAE
from genconvit_tpu_torch.ops.act import swiglu

from tests.test_torch_util import (BACKBONE_CLASSES, IMG, SMALL_DEPTHS, SMALL_DIMS, SMALL_NAME,
                                   images, small_backbone)

_ = small_backbone  # fixture
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def trees():
    """SwiGLU-head ED and VAE trees of the JAX package's init (jitted),
    the small backbone registered in the JAX package, layer scale U(0.1, 1)."""
    k_ed, k_vae = jax.random.split(jax.random.PRNGKey(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_convnext.CONVNEXT_CFGS, SMALL_NAME,
                   dict(depths=SMALL_DEPTHS, dims=SMALL_DIMS))
        out = {"ed": jax.jit(lambda k: init_ed(k, SMALL_NAME, backbone_classes=BACKBONE_CLASSES,
                                               head_act="swiglu"))(k_ed),
               "vae": jax.jit(lambda k: init_vae(k, SMALL_NAME, IMG,
                                                 backbone_classes=BACKBONE_CLASSES,
                                                 head_act="swiglu"))(k_vae)}
    rng = np.random.default_rng(0)
    for t in out.values():
        for stage in t["backbone"]["stages"]:
            for blk in stage["blocks"]:
                blk["gamma"] = jnp.asarray(rng.uniform(0.1, 1.0, blk["gamma"].shape), jnp.float32)
        # decisive verdicts for the Predictor test
        t["fc2"] = {k: v * 30.0 for k, v in t["fc2"].items()}
    return jax.tree_util.tree_map(np.asarray, out)


def test_swiglu_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 8)).astype(np.float32)
    np.testing.assert_allclose(swiglu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_swiglu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("branch", ["ed", "vae"])
def test_swiglu_heads_match_jax(trees, small_backbone, branch):
    tree = trees[branch]
    nf = 2 * BACKBONE_CLASSES
    assert tree["fc"]["kernel"].shape == (nf, nf // 2)
    sd = state_dict_from_jax(tree, branch)
    assert branch_spec(sd, branch)["head_act"] == "swiglu"
    if branch == "ed":
        m = GenConViTED(small_backbone, backbone_classes=BACKBONE_CLASSES, head_act="swiglu")
    else:
        m = GenConViTVAE(small_backbone, IMG, backbone_classes=BACKBONE_CLASSES,
                         head_act="swiglu")
    m.load_state_dict(sd, strict=True)
    m = m.eval().to(memory_format=torch.channels_last)
    _, x, x_nhwc = images(np.random.default_rng(2))
    apply = ed_apply if branch == "ed" else (lambda t, v: vae_apply(t, v, sample=False))
    ref = jax.jit(apply)(tree, jnp.asarray(x_nhwc))[0]
    with torch.no_grad():
        got = m(x) if branch == "ed" else m(x, sample=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the default head cannot hold these weights
    plain = GenConViTED(small_backbone, backbone_classes=BACKBONE_CLASSES)
    with pytest.raises(RuntimeError, match="size mismatch"):
        plain.load_state_dict(state_dict_from_jax(trees["ed"], "ed"), strict=True)


def test_predictor_loads_swiglu_gcv_written_by_jax(trees, small_backbone, tmp_path):
    for name, t in trees.items():
        jax_ckpt.save_checkpoint(str(tmp_path / f"genconvit_{name}_inference.gcv"), {name: t})
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG,
                 weight_dir=str(tmp_path))
    pred = Predictor(cfg, device="cpu", deterministic_vae=True,
                     backbone_classes=BACKBONE_CLASSES)
    assert pred.model.ed.head_act == pred.model.vae.head_act == "swiglu"
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 2, IMG, IMG, 3), dtype=np.uint8)
    mask = np.ones((3, 2), np.float32)
    mask[1, 1:] = 0
    y, y_val = pred.predict_videos_batched(frames, mask)
    x = jax_pre.normalize_batch(jnp.asarray(frames.reshape((6, IMG, IMG, 3))))
    logits, _ = jax.jit(lambda t, v: genconvit_apply(t, v, sample=False))(trees, x)
    per_video = jnp.concatenate([logits[:6].reshape(3, 2, 2), logits[6:].reshape(3, 2, 2)], 1)
    jy, jy_val = jax.vmap(jax_agg.aggregate_logits)(per_video,
                                                    jnp.concatenate([mask, mask], 1))
    np.testing.assert_array_equal(y, np.asarray(jy))
    np.testing.assert_allclose(y_val, np.asarray(jy_val), rtol=0, atol=1e-5)
