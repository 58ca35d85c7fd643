"""GenConViT training CLI of the port: the root train.py's flags (ref
train.py:161-196: -e/--epoch, -v/--version, -d/--dir, -m/--model,
-p/--pretrained, -t/--test, -b/--batch_size, and --kl, --save-best,
--img-size, --seed, --weight-dir, --vae-variant, --bf16) plus --device.

    python -m genconvit_tpu_torch.train -d DATA -m genconvit -e 1 -b 8 --bf16
    python -m genconvit_tpu_torch.train -d DATA -m ed --device cpu

It trains on the card unless --device names another device; without CUDA
that raises. The kernel plan is the environment's (GENCONVIT_PALLAS,
GENCONVIT_INT8_MLP, ...; GENCONVIT_PALLAS=mlp[:i,j] trains through the
per-stage kernel path). `--vae-variant updated` trains the updated VAE
(ref model/genconvit_vae_updated.py, the reference's train_updated.py).
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence

import torch

from genconvit_tpu_torch.config import load_config
from genconvit_tpu_torch.train.loop import train_model


def gen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m genconvit_tpu_torch.train",
                                description="Train GenConViT (PyTorch/CUDA port)")
    p.add_argument("-e", "--epoch", type=int, default=None, help="number of training epochs")
    p.add_argument("-v", "--version", default=None, help="version 0.1")
    p.add_argument("-d", "--dir", required=True, help="training data path")
    p.add_argument("-m", "--model", default="vae",
                   help="model variant: ed or vae (or genconvit for joint)")
    p.add_argument("-p", "--pretrained", default=None, help="checkpoint to resume from")
    p.add_argument("-t", "--test", default=None,
                   help="run test on the test split after training")
    p.add_argument("-b", "--batch_size", default=None, help="batch size")
    p.add_argument("--kl", action="store_true",
                   help="enable the VAE KL loss term (reference keeps it off)")
    p.add_argument("--save-best", action="store_true")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--weight-dir", default="weight")
    p.add_argument("--vae-variant", choices=["original", "updated"], default=None,
                   help="'updated' = the train_updated.py variant (fixed reparameterization, "
                        "Tanh decoder with BatchNorms, dropout head: ref "
                        "model/genconvit_vae_updated.py)")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 forward/backward, f32 master weights "
                        "and Adam state (f32 is the default)")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless given")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    start = time.perf_counter()
    args = gen_parser().parse_args(argv)
    config = load_config()
    if args.img_size:
        config.img_size = args.img_size
        config.model.latent_dims = config.derived_latent_dims()
    if args.vae_variant:
        config.model.vae_variant = args.vae_variant
    mod = args.model if args.model in ("ed", "genconvit") else "vae"
    summary = train_model(
        args.dir, mod, args.epoch if args.epoch else config.epoch,
        pretrained=args.pretrained,
        test_model=bool(args.test),
        batch_size=int(args.batch_size) if args.batch_size else config.batch_size,
        config=config,
        weight_dir=args.weight_dir,
        seed=args.seed,
        use_kl=args.kl,
        save_best=args.save_best,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device,
    )
    print(f"\n\n--- {time.perf_counter() - start:.2f} seconds ---")
    return summary


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
