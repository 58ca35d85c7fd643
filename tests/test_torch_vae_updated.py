"""The port's updated VAE variant (ref model/genconvit_vae_updated.py;
models/vae.py variant='updated') against the JAX package's
(`init_vae_updated`, `vae_updated_apply`, `convert_vae_updated`) on the
CPU, on the weights of a torch oracle with the reference's Sequential
indices (tests/test_full_model_parity.py's), BatchNorm statistics seeded,
layer scale U(0.1, 1). Small models: ConvNeXt depths (1,1,1,1), dims
(8..64), 64 px, latent 256.

  * the forward against vae_updated_apply, deterministic and with the eps
    JAX draws (logits, mu, reconstruction: rtol 1e-4, atol 1e-5, the same
    graph up to float32 summation order); train mode: logits, KL, mu,
    logvar and the 4 encoder + 3 decoder BatchNorm statistics (the same
    bounds);
  * the bridge both ways (bit for bit), `.gcv` files read by both
    packages, a reference `.pth` with the dead groups loading strict and
    matching the torch oracle (rtol 1e-3, atol 1e-4, the bounds of
    tests/test_full_model_parity.py), the Predictor building the variant
    from the weights;
  * Adam steps against JAX's make_train_step ('vae', KL on): the first from
    the same weights, the second after each package resumed the other's
    `.gcv` with its optimizer state (loss 1e-5 relative, gradients 1e-5
    relative L2, parameter changes and moments 1e-3, BatchNorm running
    statistics 2e-4 absolute: tests/test_torch_train.py's bounds and
    reasons); write_back_bn with the 7 statistics;
  * the train CLI with --vae-variant updated, and resumed from its own
    checkpoint without the flag."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from genconvit_tpu.core import checkpoint as jax_ckpt
from genconvit_tpu.core import convert as jax_convert
from genconvit_tpu.models.genconvit import genconvit_apply
from genconvit_tpu.models.vae import is_updated_vae, vae_apply
from genconvit_tpu.train.loop import make_train_step as jax_train_step
from genconvit_tpu.train.optim import make_optimizer as jax_optimizer

from genconvit_tpu_torch.config import Config, ModelConfig
from genconvit_tpu_torch.core import checkpoint as ckpt
from genconvit_tpu_torch.core.convert import (branch_spec, state_dict_from_jax,
                                              tree_from_state_dict)
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.models.genconvit import GenConViT
from genconvit_tpu_torch.models.vae import GenConViTVAE
from genconvit_tpu_torch.train import loop, optim
from genconvit_tpu_torch.train.__main__ import main as cli_main

from tests.test_torch_checkpoint import _assert_same_tree
from tests.test_torch_util import (BACKBONE_CLASSES, IMG, _prefixed, convnext_oracle,
                                   ed_state_dict, images, small_backbone, write_small_config)

_ = small_backbone  # fixture
LATENT = 256 * (IMG // 32) ** 2
TOL = dict(rtol=1e-4, atol=1e-5)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-4)
LR, WD = 1e-4, 1e-4


class UpdEncoder(nn.Module):  # ref model/genconvit_vae_updated.py:10-55
    def __init__(self):
        super().__init__()
        layers, chans = [], (3, 16, 32, 64, 128)
        for i in range(4):
            layers += [nn.Conv2d(chans[i], chans[i + 1], 3, 2, 1),
                       nn.BatchNorm2d(chans[i + 1]), nn.LeakyReLU()]
        self.features = nn.Sequential(*layers)
        flat = 128 * (IMG // 16) ** 2
        self.fc1, self.fc2 = nn.Linear(flat, 256), nn.Linear(256, 128)   # dead
        self.mu, self.var = nn.Linear(flat, LATENT), nn.Linear(flat, LATENT)


class UpdDecoder(nn.Module):  # ref :69-107
    def __init__(self):
        super().__init__()
        s = IMG // 16
        self.decoder_input = nn.Linear(LATENT, 128 * s * s)
        self.unflatten = nn.Unflatten(1, (128, s, s))
        self.features = nn.Sequential(
            nn.ConvTranspose2d(128, 64, 2, 2), nn.BatchNorm2d(64), nn.LeakyReLU(),
            nn.ConvTranspose2d(64, 32, 2, 2), nn.BatchNorm2d(32), nn.LeakyReLU(),
            nn.ConvTranspose2d(32, 16, 2, 2), nn.BatchNorm2d(16), nn.LeakyReLU(),
            nn.ConvTranspose2d(16, 3, 2, 2), nn.Tanh())

    def forward(self, z):
        return self.features(self.unflatten(self.decoder_input(z)))


def oracle(seed):
    """(modules of the reference's updated VAE in eval mode, its full
    state dict with the dead groups fc3 and encoder.fc1/fc2)."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    enc, dec = UpdEncoder(), UpdDecoder()
    with torch.no_grad():
        for m in list(enc.modules()) + list(dec.modules()):
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    bb = convnext_oracle(seed, rng)
    nf = 2 * BACKBONE_CLASSES
    fc, fc2, fc3 = nn.Linear(nf, nf // 4), nn.Linear(nf // 4, 2), nn.Linear(nf // 2, nf // 4)
    mods = {"encoder.": enc, "decoder.": dec, "convnext_backbone.": bb, "fc.": fc,
            "fc2.": fc2, "fc3.": fc3}
    sd = {}
    for prefix, m in mods.items():
        m.eval()
        _prefixed(sd, prefix, m)
    return mods, sd


@pytest.fixture(scope="module")
def weights():
    mods, sd = oracle(0)
    tree = jax_convert.convert_vae_updated(sd, carry_dead_params=False)
    return mods, sd, tree


def _port(tree, name):
    m = GenConViTVAE(name, IMG, LATENT, backbone_classes=BACKBONE_CLASSES, variant="updated")
    m.load_state_dict(state_dict_from_jax(tree, "vae"), strict=True)
    return m.eval().to(memory_format=torch.channels_last)


def _np_nchw(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("sample", [False, True])
def test_forward_matches_vae_updated_apply(weights, small_backbone, sample):
    _, _, tree = weights
    assert is_updated_vae(tree)
    rng = np.random.default_rng(1)
    _, x, x_nhwc = images(rng)
    key = jax.random.PRNGKey(5)
    ref, ref_recon, aux = jax.jit(lambda t, v, k: vae_apply(t, v, k, sample=sample))(
        tree, jnp.asarray(x_nhwc), key if sample else None)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (2, LATENT), jnp.float32)))
    m = _port(tree, small_backbone)
    with torch.no_grad():
        got, recon = m(x, sample=sample, eps=eps, return_recon=True)
        mu = m.encoder(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_np_nchw(recon), np.asarray(ref_recon), **TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(aux["mu"]), **TOL)
    if sample:   # the var head changes the verdict: the reparameterization is the fixed one
        det = jax.jit(lambda t, v: vae_apply(t, v, sample=False)[0])(tree, jnp.asarray(x_nhwc))
        assert not np.allclose(np.asarray(det), np.asarray(ref), **TOL)


def test_train_mode_matches_vae_updated_apply(weights, small_backbone):
    _, _, tree = weights
    rng = np.random.default_rng(2)
    _, x, x_nhwc = images(rng, n=4)
    key = jax.random.PRNGKey(7)
    ref, ref_recon, aux = jax.jit(lambda t, v, k: vae_apply(t, v, k, sample=True, train=True))(
        tree, jnp.asarray(x_nhwc), key)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (4, LATENT), jnp.float32)))
    m = _port(tree, small_backbone)
    got, gaux = m(x, eps=eps, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_np_nchw(gaux["recon"]), np.asarray(ref_recon), **TOL)
    for k in ("kl", "mu", "logvar"):
        np.testing.assert_allclose(gaux[k].detach().numpy(), np.asarray(aux[k]), **TOL)
    assert len(gaux["bn_stats"]) == len(aux["bn_stats"]) == 7
    for (mean, var), want in zip(gaux["bn_stats"], aux["bn_stats"]):
        np.testing.assert_allclose(mean.numpy(), np.asarray(want["mean"]), **TOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(want["var"]), **TOL)


def test_bridge_gcv_and_reference_pth(weights, small_backbone, tmp_path):
    mods, sd, tree = weights
    live = {k: v for k, v in sd.items() if not k.startswith(("fc3.", "encoder.fc1.",
                                                            "encoder.fc2."))}
    got = state_dict_from_jax(tree, "vae")
    assert set(got) == set(live)
    for k, v in live.items():
        assert torch.equal(got[k].float(), v.float()), k
    _assert_same_tree(tree_from_state_dict(got, "vae"), tree)
    assert branch_spec(got, "vae") == {"head_act": "default", "variant": "updated"}
    # .gcv: the port's writer read by flax, JAX's writer read by the port
    path, jpath = str(tmp_path / "port.gcv"), str(tmp_path / "jax.gcv")
    ckpt.save_checkpoint(path, {"vae": tree_from_state_dict(got, "vae")}, epoch=3)
    jax_ckpt.save_checkpoint(jpath, {"vae": tree}, epoch=3)
    _assert_same_tree(jax_ckpt.load_checkpoint(path)["params"],
                      jax_ckpt.load_checkpoint(jpath)["params"])
    back, meta = ckpt.load_params(jpath, "vae")
    assert meta["variant"] == "updated" and meta["epoch"] == 3
    assert all(torch.equal(back[k], got[k]) for k in got)
    # the reference's .pth, dead groups included, strict, against the oracle
    pth = str(tmp_path / "genconvit_vae_updated.pth")
    torch.save({"state_dict": sd}, pth)
    ref_sd, meta = ckpt.load_params(pth, "vae")
    assert meta["variant"] == "updated" and meta["source"] == "torch"
    m = GenConViTVAE(small_backbone, IMG, LATENT, backbone_classes=BACKBONE_CLASSES,
                     variant="updated").eval()
    m.load_state_dict(ref_sd, strict=True)
    rng = np.random.default_rng(3)
    xn, x, _ = images(rng)
    xt = torch.from_numpy(xn)
    enc, dec, bb = mods["encoder."], mods["decoder."], mods["convnext_backbone."]
    with torch.no_grad():
        mu = enc.mu(torch.flatten(enc.features(xt), start_dim=1))
        x_hat = dec(mu)
        cat = torch.cat([bb(xt), bb(x_hat)], dim=1)
        want = mods["fc2."](torch.relu(mods["fc."](torch.relu(cat))))
        got_logits = m.to(memory_format=torch.channels_last)(x, sample=False)
    np.testing.assert_allclose(got_logits.numpy(), want.numpy(), **ORACLE_TOL)


def test_predictor_builds_the_variant_from_the_weights(weights, small_backbone, tmp_path):
    """A Predictor configured for the original variant, given an updated
    `.gcv` written by the JAX package: it builds the updated module and
    scores as genconvit_apply does."""
    _, _, tree = weights
    rng = np.random.default_rng(4)
    ed_tree = jax_convert.convert_ed(ed_state_dict(4, rng))
    for name, t in (("ed", ed_tree), ("vae", tree)):
        jax_ckpt.save_checkpoint(str(tmp_path / f"genconvit_{name}_inference.gcv"), {name: t})
    cfg = Config(model=ModelConfig(backbone=small_backbone), img_size=IMG,
                 weight_dir=str(tmp_path))
    pred = Predictor(cfg, device="cpu", deterministic_vae=True,
                     backbone_classes=BACKBONE_CLASSES)
    assert pred.model.vae.updated and pred.config.model.vae_variant == "updated"
    _, x, x_nhwc = images(rng, n=3)
    want, _ = jax.jit(lambda t, v: genconvit_apply(t, v, sample=False))(
        {"ed": ed_tree, "vae": tree}, jnp.asarray(x_nhwc))
    with torch.no_grad():
        got = pred.model(x, pred.kernel_plan, sample=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _bns(tree):
    bns = tree["vae"]["encoder"]["bns"] + tree["vae"]["decoder"]["bns"]
    return [(np.asarray(b["mean"]), np.asarray(b["var"])) for b in bns]


def _port_model(name, sd):
    cfg = Config(model=ModelConfig(backbone=name, latent_dims=LATENT, vae_variant="updated"),
                 img_size=IMG)
    model = GenConViT(cfg, "vae", BACKBONE_CLASSES)
    model.vae.load_state_dict(sd)
    return model.to(memory_format=torch.channels_last)


def _check_step(port_model, opt, jparams, jstate, losses, before):
    """The port after a step against JAX after the same step from the
    parameters `before`."""
    got = loop.params_tree(port_model)
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    assert _rel(_flat(got) - _flat(before), _flat(jparams) - _flat(before)) < 1e-3
    adam = ckpt._list_form(ckpt.opt_state_tree(opt, loop.branches(port_model))["inner_state"]["1"])
    jadam = jstate.inner_state[1]
    assert int(adam["count"]) == int(jadam.count)
    for k, want in (("mu", jadam.mu), ("nu", jadam.nu)):
        assert _rel(_flat(adam[k]), _flat(want)) < 1e-3, k
    for (m, v), (jm, jv) in zip(_bns(got), _bns(jparams)):
        np.testing.assert_allclose(m, jm, rtol=0, atol=2e-4)
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-6)


def test_adam_steps_match_jax_and_resume_across(weights, small_backbone, tmp_path):
    _, _, tree = weights
    rng = np.random.default_rng(5)
    n = 4
    imgs = rng.integers(0, 256, (n, IMG, IMG, 3), np.uint8)
    labels = np.array([0, 1, 1, 0], np.int32)
    keys = list(jax.random.split(jax.random.PRNGKey(9), 2))
    eps = [torch.from_numpy(np.array(jax.random.normal(k, (n, LATENT), jnp.float32)))
           for k in keys]
    tx = jax_optimizer(LR, WD)
    jstep = jax_train_step("vae", tx, use_kl=True, donate=False)
    params = {"vae": jax.tree_util.tree_map(jnp.asarray, tree)}
    state = tx.init(params)
    p0 = jax.tree_util.tree_map(np.asarray, params)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels.astype(np.int64))

    # step 1 from the same weights
    params1, state1, jloss1, _ = jstep(params, state, jnp.asarray(imgs), jnp.asarray(labels),
                                       keys[0])
    model = _port_model(small_backbone, state_dict_from_jax(tree, "vae"))
    opt = optim.make_optimizer(model.parameters(), LR, WD)
    loss1, _ = loop.make_train_step(model, "vae", opt, use_kl=True)(x, y, eps[0])
    _check_step(model, opt, params1, state1, (float(loss1), float(jloss1)), p0)
    g_port = _flat(ckpt._list_form(
        ckpt.opt_state_tree(opt, loop.branches(model))["inner_state"]["1"]["mu"]))
    g_jax = _flat(state1.inner_state[1].mu)
    assert _rel(g_port / 0.1 - WD * _flat(p0), g_jax / 0.1 - WD * _flat(p0)) < 1e-5

    # each package resumes the other's .gcv, optimizer state included
    jpath, ppath = str(tmp_path / "jax.gcv"), str(tmp_path / "port.gcv")
    jax_ckpt.save_checkpoint(jpath, params1, epoch=1, opt_state=state1)
    ckpt.save_checkpoint(ppath, loop.params_tree(model), epoch=1,
                         opt_state=ckpt.opt_state_tree(opt, loop.branches(model)))
    payload = ckpt.load_checkpoint(jpath)
    resumed = _port_model(small_backbone, state_dict_from_jax(payload["params"]["vae"], "vae"))
    ropt = optim.make_optimizer(resumed.parameters(), LR, WD)
    ckpt.restore_opt_state(ropt, loop.branches(resumed), payload["opt_state"])
    jpayload = jax_ckpt.load_checkpoint(ppath)
    jparams_r = jax.tree_util.tree_map(jnp.asarray, jpayload["params"])
    jstate_r = jax_ckpt.restore_opt_state(tx.init(jparams_r), jpayload["opt_state"])
    assert is_updated_vae(jparams_r["vae"])
    params2, state2, jloss2, _ = jstep(jparams_r, jstate_r, jnp.asarray(imgs),
                                       jnp.asarray(labels), keys[1])
    loss2, _ = loop.make_train_step(resumed, "vae", ropt, use_kl=True)(x, y, eps[1])
    _check_step(resumed, ropt, params2, state2, (float(loss2), float(jloss2)), params1)


def test_write_back_bn_takes_the_decoders_three(small_backbone):
    cfg = Config(model=ModelConfig(backbone=small_backbone, latent_dims=LATENT,
                                   vae_variant="updated"), img_size=IMG)
    model = GenConViT(cfg, "genconvit", BACKBONE_CLASSES)
    bns = ([model.vae.encoder.features[i] for i in (1, 4, 7, 10)]
           + [model.vae.decoder.features[i] for i in (1, 4, 7)])
    stats = [(torch.full_like(bn.running_mean, float(i)),
              torch.full_like(bn.running_var, 10.0 + i)) for i, bn in enumerate(bns)]
    loop.write_back_bn(model, stats, "genconvit")
    for i, bn in enumerate(bns):
        assert torch.all(bn.running_mean == i) and torch.all(bn.running_var == 10 + i)
    with pytest.raises(ValueError, match="7 BatchNorms"):
        loop.write_back_bn(model, stats[:4], "genconvit")


@pytest.fixture
def data_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    for split, n in [("train", 4), ("valid", 2), ("test", 2)]:
        for cls in ["fake", "real"]:
            d = tmp_path / "data" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                cv2.imwrite(str(d / f"{i}.jpg"), rng.integers(0, 255, (IMG, IMG, 3), np.uint8))
    return str(tmp_path / "data")


def test_cli_trains_the_updated_variant(tmp_path, data_dir, small_backbone, monkeypatch):
    monkeypatch.setenv("GENCONVIT_CONFIG", write_small_config(tmp_path / "config.yaml"))
    args = ["-d", data_dir, "-m", "vae", "-e", "1", "-b", "4", "--weight-dir",
            str(tmp_path / "w"), "--device", "cpu"]
    first = cli_main(args + ["--vae-variant", "updated"])
    assert first["model"].vae.updated
    payload = ckpt.load_checkpoint(first["checkpoint"])
    assert is_updated_vae(payload["params"]["vae"])
    assert int(payload["opt_state"]["inner_state"]["1"]["count"]) == 2
    # resumed without the flag: the checkpoint's variant
    second = cli_main(args + ["-p", first["checkpoint"]])
    assert second["model"].vae.updated
    assert int(ckpt.load_checkpoint(second["checkpoint"])["opt_state"]["inner_state"]["1"]
               ["count"]) == 4
