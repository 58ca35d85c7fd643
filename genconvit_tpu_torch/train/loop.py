"""Training loop for the ED and VAE branches and the joint ensemble (port of
genconvit_tpu/train/loop.py).

Loss semantics from the reference:
  ED : CrossEntropy(logits, targets)                  (ref train/train_ed.py:22-23)
  VAE: CE + MSE(recon, images); the KL term is off by default, as the
       reference leaves it commented out (ref train/train_vae.py:23-25)
Optimizer: Adam with L2 decay and StepLR(15, 0.1) per epoch (train/optim.py).

One step: the uint8 batch is normalized on the device; the forward runs
under `torch.utils.checkpoint` (remat: the backward recomputes it, which
trades about a third more work for activation memory), through
`torch.func.functional_call` over the float32 master parameters and
buffers, or, in mixed precision, over their bfloat16 copies (every float
tensor, BatchNorm statistics included, as the JAX package's cast_floats),
whose casts carry the gradients back to the float32 masters. The VAE's
eps is drawn outside the recomputed region (`draw_eps`) and passed in. The
BatchNorms return their new running statistics, which the step writes to
the masters after the optimizer step (`write_back_bn`). On a CUDA
bfloat16 backbone the forward runs the plan's kernels through
differentiable autograd Functions (models/convnext.py), so each step
launches each kernel twice per forward pass: once forward and once on the
recompute.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from genconvit_tpu_torch.config import Config
from genconvit_tpu_torch.core.checkpoint import (load_checkpoint, opt_state_tree,
                                                 restore_opt_state, save_checkpoint)
from genconvit_tpu_torch.core.convert import state_dict_from_jax, tree_from_state_dict
from genconvit_tpu_torch.data.folder import load_data
from genconvit_tpu_torch.data.preprocess import normalize_batch
from genconvit_tpu_torch.device import default_device
from genconvit_tpu_torch.models.genconvit import GenConViT, model_spec
from genconvit_tpu_torch.models.init import init_genconvit_
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.train import optim

log = logging.getLogger("genconvit_tpu_torch")


def model_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the model by name."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def cast_floats(tensors: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The floating-point tensors cast to dtype (differentiable casts), the
    rest as they are (core/pytree.py cast_floats of the JAX package)."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}


def branches(model: GenConViT) -> Dict[str, torch.nn.Module]:
    return {b: getattr(model, b) for b in ("ed", "vae") if hasattr(model, b)}


def draw_eps(model: GenConViT, n: int, dtype: torch.dtype,
             generator: torch.Generator) -> Optional[torch.Tensor]:
    """The VAE's eps [n, latent] for one step (None without a VAE branch),
    drawn outside the rematerialized forward so that the recompute sees
    the same draw."""
    if not hasattr(model, "vae"):
        return None
    latent = model.vae.encoder.mu.out_features
    return torch.randn((n, latent), generator=generator, device=generator.device,
                       dtype=torch.float32).to(dtype)


def _targets(net: str, labels: torch.Tensor) -> torch.Tensor:
    return torch.cat([labels, labels]) if net == "genconvit" else labels


def make_loss_fn(model: GenConViT, net: str, use_kl: bool = False,
                 dtype: torch.dtype = torch.float32, plan: Optional[KernelPlan] = None):
    """loss_fn(images_u8, labels, eps) -> (loss, {"acc", "bn_stats"}), as
    make_loss_fn of the JAX package (loop.py:36-82) with its remat on.
    plan: resolved here, once (the environment's by default)."""
    plan = plan or KernelPlan.from_env()

    def fwd(tensors, x, eps):
        return functional_call(model, tensors, (x, plan), {"eps": eps, "train": True})

    def loss_fn(images_u8: torch.Tensor, labels: torch.Tensor,
                eps: Optional[torch.Tensor] = None):
        x = normalize_batch(images_u8, dtype)
        tensors = model_tensors(model)
        if dtype != torch.float32:
            tensors = cast_floats(tensors, dtype)
        # the whole forward is recomputed (no early stop), as jax.checkpoint does
        with set_checkpoint_early_stop(False):
            logits, aux = checkpoint(fwd, tensors, x, eps, use_reentrant=False)
        tgt = _targets(net, labels)
        loss = F.cross_entropy(logits.float(), tgt)
        if net in ("vae", "genconvit"):
            loss = loss + torch.mean(torch.square(aux["vae_recon"].float() - x.float()))
            if use_kl:   # the reference keeps this commented out (train/train_vae.py:25)
                loss = loss + aux["vae_kl"]
        acc = (logits.argmax(-1) == tgt).float().mean()
        return loss, {"acc": acc, "bn_stats": aux.get("vae_bn_stats")}

    return loss_fn


@torch.no_grad()
def write_back_bn(model: GenConViT, bn_stats, net: str) -> None:
    """The VAE's new running statistics into the master buffers, in their
    dtype (_write_back_bn of the JAX package, loop.py:85-115): the
    encoder's four, then, for the updated variant, the decoder's three
    (features.{1,4,7} of each)."""
    if bn_stats is None or net not in ("vae", "genconvit"):
        return
    vae = model.vae
    bns = [vae.encoder.features[3 * i + 1] for i in range(4)]
    if vae.updated:
        bns += [vae.decoder.features[3 * i + 1] for i in range(3)]
    if len(bn_stats) != len(bns):
        raise ValueError(f"{len(bn_stats)} BatchNorm statistics for the {vae.variant} "
                         f"VAE's {len(bns)} BatchNorms")
    for bn, (mean, var) in zip(bns, bn_stats):
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


def make_train_step(model: GenConViT, net: str, optimizer: torch.optim.Optimizer,
                    use_kl: bool = False, dtype: torch.dtype = torch.float32,
                    plan: Optional[KernelPlan] = None):
    """step(images_u8, labels, eps=None) -> (loss, acc): one optimizer step
    on the model's master parameters (make_train_step, loop.py:118-131)."""
    loss_fn = make_loss_fn(model, net, use_kl, dtype, plan)

    def step(images_u8: torch.Tensor, labels: torch.Tensor,
             eps: Optional[torch.Tensor] = None):
        optimizer.zero_grad(set_to_none=False)
        loss, aux = loss_fn(images_u8, labels, eps)
        loss.backward()
        optim.fill_missing_grads(optimizer)
        optimizer.step()
        write_back_bn(model, aux["bn_stats"], net)
        return loss.detach(), aux["acc"]

    return step


def make_eval_step(model: GenConViT, net: str, dtype: torch.dtype = torch.float32,
                   plan: Optional[KernelPlan] = None):
    """step(images_u8, labels, eps=None) -> (loss, acc, preds), BatchNorms on
    their running statistics, the same mixed precision as training
    (make_eval_step, loop.py:134-159; like it, no KL term)."""
    plan = plan or KernelPlan.from_env()

    @torch.no_grad()
    def step(images_u8: torch.Tensor, labels: torch.Tensor,
             eps: Optional[torch.Tensor] = None):
        x = normalize_batch(images_u8, dtype)
        tensors = model_tensors(model)
        if dtype != torch.float32:
            tensors = cast_floats(tensors, dtype)
        logits, aux = functional_call(model, tensors, (x, plan),
                                      {"eps": eps, "return_aux": True})
        tgt = _targets(net, labels)
        loss = F.cross_entropy(logits.float(), tgt)
        if net in ("vae", "genconvit"):
            loss = loss + torch.mean(torch.square(aux["vae_recon"].float() - x.float()))
        preds = logits.argmax(-1)
        return loss, (preds == tgt).float().mean(), preds

    return step


def params_tree(model: GenConViT) -> Dict[str, Any]:
    """The JAX package's parameter tree of the model, BatchNorm statistics
    included, nested by branch as train_model saves it."""
    return {b: tree_from_state_dict(m.state_dict(), b) for b, m in branches(model).items()}


def new_model(config: Config, net: str, device: torch.device, seed: int,
              backbone_classes: int = 1000, head_act="default") -> GenConViT:
    """A float32 GenConViT on the device, initialized from `seed`, 4-D
    weights channels_last as the activations. The VAE is the variant
    config.model.vae_variant names; head_act as GenConViT takes it."""
    with torch.device("meta"):
        model = GenConViT(config, net, backbone_classes, head_act)
    model = model.to_empty(device=device)
    init_genconvit_(model, torch.Generator(device=device).manual_seed(seed))
    return model.to(memory_format=torch.channels_last)


def train_model(
    dir_path: str,
    mod: str = "ed",
    num_epochs: int = 1,
    pretrained: Optional[str] = None,
    test_model: bool = False,
    batch_size: int = 32,
    config: Optional[Config] = None,
    weight_dir: Optional[str] = None,
    seed: int = 1,  # ref train.py:67 torch.manual_seed(1)
    use_kl: bool = False,
    save_best: bool = False,
    log_every: int = 10,
    dtype: torch.dtype = torch.float32,   # torch.bfloat16: mixed precision
    device: Any = None,
    plan: Optional[KernelPlan] = None,
) -> Dict[str, Any]:
    """Mirror of ref train.py:36-127 on one device (train_model of the JAX
    package, loop.py:162-305, without its data parallelism): the data order
    of `load_data`, the `.pkl` history, `genconvit_{mod}_best.gcv` under
    save_best, the final checkpoint with the optimizer state and the
    reference's epoch (start + epochs + 1), and the test accuracy with
    quirk B5 fixed. device: the card unless given. Returns a summary."""
    config = config or Config()
    weight_dir = weight_dir or config.weight_dir
    device = torch.device(device) if device is not None else default_device()
    datasets, sizes = load_data(dir_path, batch_size, config.img_size, seed=seed)
    log.info("data: %s", sizes)

    payload = load_checkpoint(pretrained) if pretrained else None
    classes, sds = 1000, {}
    if payload is not None:
        # the module the file's weights need: the backbone head's width, each
        # branch's head and the VAE's variant, as the file has them
        sds = {b: state_dict_from_jax(t, b) for b, t in payload["params"].items()}
        tree = next(iter(payload["params"].values()))
        classes = int(np.shape(tree["backbone"]["head"]["fc"]["kernel"])[-1])
    config, heads = model_spec(config, sds)
    model = new_model(config, mod, device, seed, classes, heads)
    parts = branches(model)
    optimizer = optim.make_optimizer(model.parameters(), config.learning_rate,
                                     config.weight_decay)
    start_epoch = 0
    min_loss = float(config.min_val_loss)
    if payload is not None:
        for b, m in parts.items():
            m.load_state_dict(sds[b])
        if payload.get("opt_state") is not None:
            restore_opt_state(optimizer, parts, payload["opt_state"])
        start_epoch = payload.get("epoch", 0)
        min_loss = payload.get("min_loss", min_loss)
        log.info("resumed from %s (epoch %d)", pretrained, start_epoch)

    plan = plan or KernelPlan.from_env()
    train_step = make_train_step(model, mod, optimizer, use_kl, dtype, plan)
    eval_step = make_eval_step(model, mod, dtype, plan)
    lr_of = optim.step_lr(config.learning_rate)

    def upload(imgs, labels):
        return (torch.from_numpy(imgs).to(device),
                torch.from_numpy(np.asarray(labels, np.int64)).to(device))

    history = {"train_loss": [], "train_acc": [], "valid_loss": [], "valid_acc": []}
    epoch_loss = min_loss
    # best-so-far starts from the checkpoint's min_loss, so that a resumed
    # run cannot overwrite genconvit_*_best.gcv with a worse epoch
    best_val = min_loss
    since = time.time()
    step_gen = torch.Generator(device=device).manual_seed(seed + 1)

    for epoch in range(start_epoch, start_epoch + num_epochs):
        optim.set_lr(optimizer, lr_of(epoch))
        losses, accs = [], []
        for bi, (imgs, labels) in enumerate(
                datasets["train"].batches(batch_size, shuffle=True, epoch=epoch)):
            x, y = upload(imgs, labels)
            loss, acc = train_step(x, y, draw_eps(model, len(labels), dtype, step_gen))
            losses.append(float(loss))
            accs.append(float(acc))
            if bi % log_every == 0:
                log.info("epoch %d batch %d: loss %.4f acc %.4f", epoch, bi, losses[-1], accs[-1])
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        history["train_loss"].append(epoch_loss)
        history["train_acc"].append(float(np.mean(accs)) if accs else float("nan"))

        vlosses, vaccs = [], []
        for imgs, labels in datasets["valid"].batches(batch_size):
            x, y = upload(imgs, labels)
            loss, acc, _ = eval_step(x, y, draw_eps(model, len(labels), dtype, step_gen))
            vlosses.append(float(loss))
            vaccs.append(float(acc))
        vloss = float(np.mean(vlosses)) if vlosses else float("nan")
        history["valid_loss"].append(vloss)
        history["valid_acc"].append(float(np.mean(vaccs)) if vaccs else float("nan"))
        log.info("epoch %d: train %.4f/%.4f  valid %.4f/%.4f  (lr %.2e)",
                 epoch, history["train_loss"][-1], history["train_acc"][-1],
                 vloss, history["valid_acc"][-1], lr_of(epoch))
        if save_best and vloss < best_val:
            best_val = vloss
            save_checkpoint(os.path.join(weight_dir, f"genconvit_{mod}_best.gcv"),
                            params_tree(model), epoch=epoch + 1, min_loss=vloss,
                            extra={"history": history})

    elapsed = time.time() - since
    log.info("Training complete in %.0fm %.0fs", elapsed // 60, elapsed % 60)

    stamp = time.strftime("%b_%d_%Y_%H_%M_%S", time.localtime())
    base = os.path.join(weight_dir, f"genconvit_{mod}_{stamp}")
    os.makedirs(weight_dir, exist_ok=True)
    with open(f"{base}.pkl", "wb") as f:
        pickle.dump([history["train_loss"], history["train_acc"],
                     history["valid_loss"], history["valid_acc"]], f)
    ckpt_path = f"{base}.gcv"
    save_checkpoint(ckpt_path, params_tree(model),
                    epoch=start_epoch + num_epochs + 1,  # ref semantics: epochs + 1
                    min_loss=epoch_loss, opt_state=opt_state_tree(optimizer, parts))
    log.info("saved %s", ckpt_path)

    summary: Dict[str, Any] = {"history": history, "checkpoint": ckpt_path, "model": model,
                               "optimizer": optimizer}
    if test_model:
        correct, total = 0, 0
        for imgs, labels in datasets["test"].batches(batch_size):
            x, y = upload(imgs, labels)
            _, _, preds = eval_step(x, y, draw_eps(model, len(labels), dtype, step_gen))
            # the correct accuracy (the reference's test() indexes labels by
            # prediction, quirk B5, which is fixed here as in the JAX package)
            correct += int((preds[: len(labels)].cpu().numpy() == np.asarray(labels)).sum())
            total += len(labels)
        log.info("Prediction: %d/%d %.2f%%", correct, total, 100.0 * correct / max(total, 1))
        summary["test_accuracy"] = correct / max(total, 1)
    return summary
