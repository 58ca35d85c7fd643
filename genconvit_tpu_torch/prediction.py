"""GenConViT prediction CLI on the PyTorch/CUDA port, flag-compatible with
the repository's `prediction.py` (and with the reference's, ref
prediction.py:269-338):

    python -m genconvit_tpu_torch.prediction --p DIR [--f 15] [--d dataset]
        [--s tiny|large] [--e NAME] [--v NAME] [--fp16 x] [--net ...]
        [--face-backend B] [--face-sidecar JSON] [--weights-dir D]
        [--json-dir D] [--result-dir D] [--deterministic-vae]
        [--device cuda|cpu] [--workers N]

Videos under --p are decoded on the host (cv2, or native/libgcvdecode.so
where it is built), faces detected and cropped, the ensemble scores them on
the card (--device cpu runs the plain float32 path on the CPU), and the
result JSON goes to --result-dir. `--transfer-format yuv420` is refused:
the YUV path is not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List, Optional

from genconvit_tpu_torch.config import apply_size, load_config
from genconvit_tpu_torch.infer.engine import Predictor
from genconvit_tpu_torch.infer.result import attach_metadata, result_path, write_result
from genconvit_tpu_torch.infer.walkers import WALKERS, vids


def gen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GenConViT prediction (PyTorch/CUDA)")
    p.add_argument("--p", type=str, help="video or directory path")
    p.add_argument("--f", type=int, default=15,
                   help="number of frames to process for prediction")
    p.add_argument("--d", type=str, default="other",
                   help="dataset type: dfdc, faceforensics, timit, celeb")
    p.add_argument("--s", type=str, help="model size: tiny, large")
    p.add_argument("--e", nargs="?", const="genconvit_ed_inference",
                   default="genconvit_ed_inference", help="weight for ed")
    p.add_argument("--v", "--value", dest="v", nargs="?",
                   const="genconvit_vae_inference",
                   default="genconvit_vae_inference", help="weight for vae")
    p.add_argument("--fp16", type=str, default=None, help="half precision (bfloat16)")
    p.add_argument("--net", choices=["ed", "vae", "genconvit"],
                   default="genconvit", help="branch selection (working B14 fix)")
    p.add_argument("--face-backend", default=None,
                   help="jax|hybrid|haar|fullframe|center|skin|recorded")
    p.add_argument("--face-sidecar", default=None,
                   help="recorded-boxes JSON for --face-backend recorded")
    p.add_argument("--weights-dir", default="weight")
    p.add_argument("--json-dir", default="json_file")
    p.add_argument("--result-dir", default="result")
    p.add_argument("--deterministic-vae", action="store_true",
                   help="z = mu instead of eval-time sampling (quirk B4 off)")
    p.add_argument("--transfer-format", choices=["rgb", "yuv420"], default="rgb",
                   help="yuv420: not ported yet (refused)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--workers", type=int, default=8)
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
    if args.face_sidecar:
        os.environ["GENCONVIT_FACE_SIDECAR"] = args.face_sidecar
        if args.face_backend is None:
            args.face_backend = "recorded"

    predictor = Predictor(config, net=args.net, ed_weight=args.e, vae_weight=args.v,
                          fp16=bool(args.fp16), face_backend=args.face_backend,
                          deterministic_vae=args.deterministic_vae, device=args.device)

    dataset = args.d if args.d in ("dfdc", "faceforensics", "timit", "celeb") else "other"
    if dataset == "other":
        state = vids(predictor, args.p, args.f, workers=args.workers)
    elif dataset == "timit":
        state = WALKERS[dataset](predictor, args.p, args.f, workers=args.workers)
    else:
        state = WALKERS[dataset](predictor, args.p, args.f, json_dir=args.json_dir,
                                 workers=args.workers)

    runtime = time.perf_counter() - start
    attach_metadata(state.result, dataset=dataset, net=args.net,
                    num_frames=args.f, runtime_seconds=runtime)
    out = write_result(state.result, result_path(args.result_dir, dataset, args.net))
    if state.has_labels:
        labeled = len(state.y_true)  # unlabeled videos don't dilute accuracy
        print(f"accuracy: {state.correct}/{labeled}"
              f" = {state.correct / max(labeled, 1):.4f}")
    print(f"result written to {out}")
    print(f"\n\n--- {runtime:.2f} seconds ---")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
