"""Metrics-enabled prediction CLI of the PyTorch/CUDA port, flag-compatible
with the repository's `prediction_v2.py` (ref prediction_v2.py:320-521),
plus --device:

    python -m genconvit_tpu_torch.prediction_v2 --p DIR [--f 15] [--d dataset]
        [--s tiny|large] [--e NAME] [--v NAME] [--fp16 x] [--arch-type original|v2]
        [--net ...] [--face-backend B] [--weights-dir D] [--json-dir D]
        [--result-dir D] [--workers N] [--device cuda|cpu]

The spine of `prediction` plus the v2 result JSON: a metrics block
(accuracy, precision, recall, F1 in numpy, infer/result.compute_metrics) and
a metadata block with arch_type, model_size and the stage timers. Ground
truth follows the v2 CLI's own heuristics (the walkers' v2_labels=True):
flat directories by filename containing 'fake', DFDC by the '_0.mp4' suffix,
timit walking the real directories too. --arch-type v2 runs the same graph
as 'original' (the reference's v2 module is never instantiated, SURVEY.md §8
B12); --use-attention and --use-residual are accepted and ignored, as in
the reference. `--transfer-format yuv420` is refused: the YUV path is not
ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List, Optional

from genconvit_tpu_torch.config import apply_size, load_config
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.infer.result import (attach_metadata, attach_metrics, result_path,
                                              write_result)
from genconvit_tpu_torch.infer.walkers import WALKERS, vids


def gen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GenConViT prediction v2 (PyTorch/CUDA)")
    p.add_argument("--p", type=str, help="video or directory path")
    p.add_argument("--f", type=int, default=15)
    p.add_argument("--d", type=str, default="other")
    p.add_argument("--s", type=str)
    p.add_argument("--e", nargs="?", const="genconvit_ed_inference",
                   default="genconvit_ed_inference")
    p.add_argument("--v", "--value", dest="v", nargs="?",
                   const="genconvit_vae_inference", default="genconvit_vae_inference")
    p.add_argument("--fp16", type=str, default=None)
    p.add_argument("--arch-type", choices=["original", "v2"], default="original",
                   help="accepted for compatibility; v2 == original (B12)")
    p.add_argument("--use-attention", action="store_true", help="ignored (B12)")
    p.add_argument("--use-residual", action="store_true", help="ignored (B12)")
    p.add_argument("--net", choices=["ed", "vae", "genconvit"], default="genconvit")
    p.add_argument("--face-backend", default=None)
    p.add_argument("--transfer-format", choices=["rgb", "yuv420"], default="rgb",
                   help="yuv420: not ported yet (refused)")
    p.add_argument("--weights-dir", default="weight")
    p.add_argument("--json-dir", default="json_file")
    p.add_argument("--result-dir", default="result")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[List[str]] = None) -> str:
    """Run the CLI on argv (sys.argv[1:] by default); returns the path of
    the result JSON."""
    start = time.perf_counter()
    args = gen_parser().parse_args(argv)
    if not args.p or not os.path.isdir(args.p):
        raise SystemExit(f"error: --p must name an existing directory (got {args.p!r})")
    if args.transfer_format == "yuv420":
        raise NotImplementedError(
            "--transfer-format yuv420: the YUV420 path (predict_files_yuv, "
            "normalize_yuv420) is not ported yet")
    config = load_config()
    if args.s:
        apply_size(config, args.s)
    config.weight_dir = args.weights_dir

    predictor = Predictor(config, net=args.net, ed_weight=args.e, vae_weight=args.v,
                          fp16=bool(args.fp16), face_backend=args.face_backend,
                          device=args.device)

    dataset = args.d if args.d in WALKERS else "other"
    if dataset == "other":
        state = vids(predictor, args.p, args.f, workers=args.workers, v2_labels=True)
    elif dataset == "timit":
        state = WALKERS[dataset](predictor, args.p, args.f, workers=args.workers,
                                 v2_labels=True)
    else:
        state = WALKERS[dataset](predictor, args.p, args.f, json_dir=args.json_dir,
                                 workers=args.workers, v2_labels=True)

    runtime = time.perf_counter() - start
    attach_metrics(state.result, state.y_true, state.y_pred)
    attach_metadata(state.result, dataset=dataset, net=args.net, num_frames=args.f,
                    runtime_seconds=runtime,
                    extra={"arch_type": args.arch_type, "model_size": args.s or "tiny",
                           "stage_timers": predictor.timers.summary()})
    out = write_result(state.result, result_path(args.result_dir, dataset,
                                                 f"{args.net}_{args.arch_type}"))
    if state.result.get("metrics"):
        print("metrics:", state.result["metrics"])
    print(f"result written to {out}")
    print(f"\n\n--- {runtime:.2f} seconds ---")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
