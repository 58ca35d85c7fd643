"""Prediction engine (port of genconvit_tpu/infer/engine.py:64-150,
281-308, 349-969).

A uint8 face batch [V,F,S,S,3] with a [V,F] frame mask goes to the device
once; normalization, the ensemble and the masked per-video aggregation run
there. The Predictor runs on the GPU unless device="cpu" is passed: bfloat16
on CUDA (the kernel backbone), float32 on the CPU. The plan's int8 switches
(GENCONVIT_INT8_HEADS, GENCONVIT_INT8_MLP) apply as in the JAX engine
(infer/engine.py:223-237 there): the latent heads quantize after the dtype
cast, and the backbone folds follow plan.int8_mlp. GENCONVIT_PALLAS=1 or
stage selects the fused-block (K5) or fused-stage (K6) backbone, whose
weight packs are made at construction in place of the folds; mlp,
mlp:<i,j,...> and mlpfull run K1 (or K4) per stage or over the backbone
(models/convnext.py). A non-zero plan.dw_rank (GENCONVIT_DW_RANK) attaches
the separable depthwise factors after the cast and before the folds, as
the JAX engine does (:178-213 there), logs their retained SVD energy and
keeps it as `dw_sep_stats`; it is refused with pallas '1' and 'stage'.

Weights come from `ed_weight`/`vae_weight` (a path, or a name resolved in
config.weight_dir as the JAX engine resolves it: `.gcv`, `.msgpack`, then
the reference's `.pth`), from `params`, or, where none is found, from a
seeded random init with the JAX engine's warning. The module is built
from the weights' structure, as the JAX package dispatches on its trees:
the VAE variant (updated where the weights hold decoder.decoder_input)
and each branch's head (SwiGLU where fc emits twice fc2's input width);
config.model.vae_variant for a random init. A Swin backbone
(config.model.backbone a SWIN_CFGS name) scores under net 'ed' alone,
and refuses the plans that name ConvNeXt-only kernels at construction
(`GenConViT.check_plan`).

The file drivers (`predict_video`, `predict_frames_dir`, `predict_files`
and its grouped form for detector backends) decode on the host with the
module-level `extract_frames`, looked up when called; each video's frames
then go to the device once: the device detector cuts its windows from that
copy and `crop_faces` crops the faces from it. Verdicts stay on the device
until one fetch at the end of a call.

With the fullframe backend and the native decoder (`data/native.py`,
looked up through that module when called) the JAX engine's fast paths
run: `extract_faces` decodes straight to the model size and skips detect
and crop (:444-470 there); `predict_files` decodes whole groups in the
library's thread pool (`predict_files_native_rgb`, :604-651) or, under
transfer_format='yuv420', ships planar YUV420 with a per-video [3,4]
colour transform and converts on the device (`predict_files_yuv`,
`forward_batched_yuv`, `predict_videos_stream_yuv`; :517-602, :875-940).

Under `torch.profiler` each forward's host enqueue is the span
gcv.predictor.launch, the stream's staging of a batch gcv.predictor.stage,
and each StageTimers stage gcv.stage.<name> (`utils/timing.py`).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.config import Config
from genconvit_tpu_torch.core.checkpoint import load_params, resolve_weight
from genconvit_tpu_torch.data import native
from genconvit_tpu_torch.data.faces import (FaceDetector, FullFrameDetector,
                                            RecordedDetector, crop_faces, make_detector)
from genconvit_tpu_torch.data.frames import sample_frame_indices
from genconvit_tpu_torch.data.preprocess import (normalize_batch, normalize_yuv420, pad_faces,
                                                 yuv_affine)
from genconvit_tpu_torch.data.video import _maybe_inject_fault, extract_frames
from genconvit_tpu_torch.device import default_device
from genconvit_tpu_torch.infer.aggregate import DEFAULT_VERDICT, aggregate_logits
from genconvit_tpu_torch.models.genconvit import GenConViT, model_spec
from genconvit_tpu_torch.models.init import init_genconvit_
from genconvit_tpu_torch.ops.dwsep import add_dw_sep_
from genconvit_tpu_torch.ops.kernel_plan import KernelPlan
from genconvit_tpu_torch.utils.timing import StageTimers, span

log = logging.getLogger("genconvit_tpu_torch")

Verdict = Optional[Tuple[int, float]]
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def default_compute_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _backbone_classes(params: Mapping[str, Mapping[str, Any]], default: int) -> int:
    """The backbones' head width as the weights have it (the JAX package
    reads every shape off its trees), else `default` for a random init."""
    for name, key in (("ed", "backbone.head.fc.weight"), ("ed", "backbone.head.weight"),
                      ("vae", "convnext_backbone.head.fc.weight")):
        if key in params.get(name, {}):
            return int(params[name][key].shape[0])
    return default


def _pad_videos(block: np.ndarray, video_batch: int) -> np.ndarray:
    """[v, ...] -> [video_batch, ...] with zero videos (an all-zero mask)
    after the v given; as it is when v >= video_batch."""
    pad = video_batch - len(block)
    if pad <= 0:
        return block
    return np.concatenate([block, np.zeros((pad,) + block.shape[1:], block.dtype)])


class Predictor:
    """params: {'ed': state_dict, 'vae': state_dict} with the reference
    checkpoints' keys (core/convert.py makes them from the JAX package's
    trees), or None to load `ed_weight`/`vae_weight` (random init from
    `seed` for a branch whose weights are not found)."""

    def __init__(self, config: Optional[Config] = None, *,
                 net: str = "genconvit", device: Any = None,
                 params: Optional[Mapping[str, Mapping[str, Any]]] = None,
                 ed_weight: Optional[str] = None, vae_weight: Optional[str] = None,
                 seed: int = 0, deterministic_vae: bool = False,
                 kernel_plan: Optional[KernelPlan] = None,
                 dtype: Optional[torch.dtype] = None, fp16: bool = False,
                 face_backend: Optional[str] = None,
                 prefer_native_decode: bool = True,
                 transfer_format: str = "rgb",   # 'rgb' | 'yuv420' (fullframe + native)
                 backbone_classes: int = 1000):
        self.config = config or Config()
        self.net = net
        self.device = torch.device(device) if device is not None else default_device()
        # --fp16 maps to bfloat16, as in the JAX engine
        self.dtype = dtype or (torch.bfloat16 if fp16 else
                               getattr(torch, self.config.compute_dtype)
                               if self.config.compute_dtype != "float32"
                               else default_compute_dtype(self.device))
        self.kernel_plan = kernel_plan or KernelPlan.from_env()
        if self.kernel_plan.dw_sep and self.kernel_plan.pallas in ("1", "stage"):
            # their kernels convolve the exact 7x7 weights: the run would be
            # exact while the logs claim the approximation
            raise ValueError(
                f"dw_rank={self.kernel_plan.dw_rank} is not supported with "
                f"GENCONVIT_PALLAS={self.kernel_plan.pallas!r}: the 'stage'/'1' kernels "
                "convolve the exact 7x7 weights and ignore separable factors. Use the "
                "default backbone ('' / 'mlp' / 'mlpfull' / '0').")
        self.dw_sep_stats: Optional[Dict[str, Any]] = None
        self.deterministic_vae = deterministic_vae
        self.prefer_native_decode = prefer_native_decode
        self.transfer_format = transfer_format
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._copy_stream = None   # the streams' uploads (CUDA)
        self.timers = StageTimers()
        self.detector = self._make_detector(face_backend or self.config.face_backend)

        branches = [b for b in ("ed", "vae") if net in (b, "genconvit")]
        if params is None:   # a branch whose weights are not found is left out (warned)
            params = self._load_weights(branches, {"ed": ed_weight, "vae": vae_weight})
        elif any(b not in params for b in branches):
            raise KeyError(f"params has {sorted(params)}; net={net!r} needs {branches}")
        self.config, heads = model_spec(self.config, params)
        with torch.device("meta"):
            model = GenConViT(self.config, net, _backbone_classes(params, backbone_classes),
                              heads)
        model.check_plan(self.kernel_plan)   # a Swin backbone refuses ConvNeXt-only kernels
        model = model.to_empty(device=self.device)
        if any(b not in params for b in branches):
            init_genconvit_(model, self.generator)
        for name in branches:
            if name in params:
                sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                      for k, v in params[name].items()}
                getattr(model, name).load_state_dict(sd, strict=True)
        # cast once (the latent heads alone are 630M parameters), then hold
        # every 4-D weight channels_last like the activations
        model = model.to(self.dtype).to(memory_format=torch.channels_last).eval()
        if self.kernel_plan.dw_sep:
            # after the cast: the SVD factorizes the weights the exact path
            # would convolve with
            t = time.perf_counter()
            sst = self.dw_sep_stats = add_dw_sep_(model, self.kernel_plan.dw_rank)
            log.info("init: dw_rank=%s separable fold %.1fs (%d filter-channels across %d "
                     "blocks [rank mix %s, %d exact], retained SVD energy mean %.3f min %.3f "
                     "— APPROXIMATE inference)", self.kernel_plan.dw_rank,
                     time.perf_counter() - t, int(sst["count"]), int(sst["blocks_sep"]),
                     sst["rank_hist"], int(sst["blocks_exact"]), sst["energy_mean"],
                     sst["energy_min"])
        if self.kernel_plan.int8_heads:
            # after the cast, as the JAX engine does: the int8 weights come
            # from the weights the default path would multiply with
            model.quantize_heads_int8_()
        self.model = model
        self.prepare_kernels()

    def prepare_kernels(self) -> None:
        """The bf16 model's K1/K4 folds or K5/K6 packs for the plan, from
        its current weights (again after any change to them)."""
        if self.dtype == torch.bfloat16:
            self.model.prepare_kernels(self.kernel_plan)

    # ------------------------------------------------------------- set-up

    def _make_detector(self, backend: str) -> FaceDetector:
        """The JAX engine's ladder (:106-130 there): a detector-family
        backend whose artifacts are missing falls to the next of jax, haar,
        fullframe; any other choice falls straight to fullframe. Each step
        down is logged."""
        if backend in ("hybrid", "jax", "haar"):
            ladder = [backend] + [b for b in ("jax", "haar", "fullframe") if b != backend]
        else:
            ladder = [backend, "fullframe"]
        for cand in ladder:
            try:
                det = make_detector(cand, device=self.device)
            except (FileNotFoundError, KeyError, ValueError) as e:
                log.warning("face backend %r unavailable (%s); trying next", cand, e)
                continue
            if cand != backend:
                log.warning("face backend %r -> fell back to %r", backend, cand)
            return det
        raise AssertionError("unreachable: fullframe always builds")

    def _load_weights(self, branches: Sequence[str], specs: Mapping[str, Optional[str]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each branch's state dict from its weight file (:281-308 there);
        a branch with none found is left out, with the JAX engine's warning."""
        wd = self.config.weight_dir
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for branch in branches:
            spec = specs[branch]
            path = spec if spec and os.path.isfile(spec) else (
                resolve_weight(wd, spec) if spec else
                resolve_weight(wd, f"genconvit_{branch}_inference"))
            if path:
                out[branch], meta = load_params(path, branch)
                log.info("loaded %s weights from %s (%s)", branch, path, meta["source"])
            else:
                log.warning("no %s weights found (looked for %r in %r) — using RANDOM "
                            "init; predictions will be meaningless", branch, spec, wd)
        return out

    # ------------------------------------------------------------- forward

    @torch.inference_mode()
    def video_logits(self, frames_u8: torch.Tensor, mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     model: Optional[GenConViT] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device tensors [V,F,S,S,3] uint8 and [V,F] -> per-video logits
        [V,K,2] and mask [V,K] (K = 2F for the ensemble, ED rows first).
        generator: the VAE's draw when it samples (the predictor's own by
        default). model: another copy of the predictor's model to run (a
        rank's split copy, parallel/eval_shard.sharded_params)."""
        v, f = frames_u8.shape[:2]
        x = normalize_batch(frames_u8.reshape((v * f,) + frames_u8.shape[2:]),
                            self.dtype)
        return self._per_video_logits(x, v, f, mask, generator, model)

    @torch.inference_mode()
    def video_logits_yuv(self, yp: torch.Tensor, up: torch.Tensor, vp: torch.Tensor,
                         matrix: torch.Tensor, mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """video_logits of planar YUV420: y [V,F,S,S], u and v [V,F,S/2,S/2]
        uint8, matrix [3,3|4] or one per video [V,3,3|4], mask [V,F]."""
        v, f = yp.shape[:2]
        if matrix.dim() == 3:   # one transform a video -> one a frame
            matrix = matrix.repeat_interleave(f, dim=0)
        x = normalize_yuv420(yp.reshape((v * f,) + yp.shape[2:]),
                             up.reshape((v * f,) + up.shape[2:]),
                             vp.reshape((v * f,) + vp.shape[2:]), matrix, self.dtype)
        return self._per_video_logits(x, v, f, mask)

    def _per_video_logits(self, x: torch.Tensor, v: int, f: int, mask: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          model: Optional[GenConViT] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = (model or self.model)(x, self.kernel_plan,
                                       sample=not self.deterministic_vae,
                                       generator=self.generator if generator is None
                                       else generator)
        if self.net == "genconvit":
            ed, vae = logits[: v * f], logits[v * f:]
            per_video = torch.cat([ed.reshape(v, f, 2), vae.reshape(v, f, 2)], dim=1)
            return per_video, torch.cat([mask, mask], dim=1)
        return logits.reshape(v, f, 2), mask

    @torch.inference_mode()
    def forward_batched(self, frames_u8: torch.Tensor, mask: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        model: Optional[GenConViT] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident [V,F,S,S,3] uint8 + [V,F] -> device (y, y_val);
        no host sync (the benchmark loop's entry). generator and model as
        in video_logits."""
        return aggregate_logits(*self.video_logits(frames_u8, mask, generator, model))

    @torch.inference_mode()
    def forward_batched_yuv(self, yp: torch.Tensor, up: torch.Tensor, vp: torch.Tensor,
                            matrix: torch.Tensor, mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """forward_batched of device-resident YUV420 planes (the JAX
        engine's _forward_fn_yuv, :875-917 there): the conversion runs in
        the normalization; no host sync."""
        return aggregate_logits(*self.video_logits_yuv(yp, up, vp, matrix, mask))

    def _launch(self, faces: List[torch.Tensor], masks: List[torch.Tensor],
                video_batch: int) -> torch.Tensor:
        """One forward of a group, the tail padded to video_batch videos:
        device [2, V] (y, y_val) rows, not fetched."""
        with span("gcv.predictor.launch"):
            faces_b, masks_b = torch.stack(faces), torch.stack(masks)
            pad = video_batch - len(faces)
            if pad > 0:
                faces_b = torch.cat([faces_b, faces_b.new_zeros((pad,) + faces_b.shape[1:])])
                masks_b = torch.cat([masks_b, masks_b.new_zeros((pad,) + masks_b.shape[1:])])
            return self._rows(self.forward_batched(faces_b, masks_b))

    @staticmethod
    def _rows(verdicts: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """A forward's (y, y_val) as device [2, V] float32 rows."""
        y, y_val = verdicts
        return torch.stack([y.float(), y_val.float()])

    def _fetch(self, names_per_launch: List[List[Any]], launches: List[torch.Tensor],
               ordered: Dict[Any, Verdict]) -> None:
        """ONE device->host fetch of every launch's verdicts; a launch's
        [2, V] rows may hold padding past its names."""
        with self.timers.stage("device_forward"):
            if not launches:
                return
            rows = torch.cat(launches, dim=1).cpu().numpy()     # [2, sum V]
            off = 0
            for names, launch in zip(names_per_launch, launches):
                for i, p in enumerate(names):
                    ordered[p] = (int(rows[0, off + i]), float(rows[1, off + i]))
                off += launch.shape[1]

    # ------------------------------------------------------------- API

    def predict_videos_batched(self, faces_batch, masks) -> Tuple[np.ndarray, np.ndarray]:
        """[V,F,S,S,3] uint8 + [V,F] (numpy or device tensors) ->
        (y [V] int64, y_val [V] float32)."""
        frames = torch.as_tensor(faces_batch).to(self.device, non_blocking=True)
        mask = torch.as_tensor(masks, dtype=torch.float32).to(self.device)
        y, y_val = self.forward_batched(frames, mask)
        return y.cpu().numpy(), y_val.cpu().numpy()

    def predict_videos_stream(self, batches: Iterable[Tuple[Any, Any]]
                              ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined scoring of a stream of ([V,F,S,S,3] uint8, [V,F])
        batches (:942-969 there): batch i+1 goes up before batch i's forward
        is issued (on the card: from pinned host memory, non_blocking, on a
        copy stream the forward waits for), each launch's [2, V] verdict
        rows stay on the device, no sync between launches, and ONE fetch
        at the end. Returns (y [V] int64, y_val [V] float32) per batch."""
        return self._stream(((faces, torch.as_tensor(masks, dtype=torch.float32))
                             for faces, masks in batches), self.forward_batched)

    def predict_videos_stream_yuv(self, batches: Iterable[Tuple[Any, Any, Any]]
                                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """predict_videos_stream of ((y, u, v) planes [V,F,...] uint8,
        matrix [3,3|4] or [V,3,3|4], mask [V,F]) batches (:919-940 there):
        the three planes, the matrix and the mask go up on the copy stream,
        the forward is forward_batched_yuv."""
        return self._stream(((*planes, torch.as_tensor(matrix, dtype=torch.float32),
                              torch.as_tensor(masks, dtype=torch.float32))
                             for planes, matrix, masks in batches), self.forward_batched_yuv)

    def _stream(self, batches: Iterable[Tuple[Any, ...]], forward
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Each batch's arrays staged before the previous batch's forward
        is issued; one fetch at the end."""
        launches: List[torch.Tensor] = []
        staged = None
        for arrays in batches:
            nxt = self._stage_batch(arrays)
            if staged is not None:
                launches.append(self._stream_launch(forward, *staged))
            staged = nxt
        if staged is not None:
            launches.append(self._stream_launch(forward, *staged))
        keys = [[(b, i) for i in range(rows.shape[1])] for b, rows in enumerate(launches)]
        ordered: Dict[Any, Verdict] = {}
        self._fetch(keys, launches, ordered)
        return [(np.array([ordered[k][0] for k in ks], np.int64),
                 np.array([ordered[k][1] for k in ks], np.float32)) for ks in keys]

    def _stage_batch(self, arrays: Sequence[Any]
                     ) -> Tuple[List[torch.Tensor], Optional["torch.cuda.Event"]]:
        """(the arrays on the device, ready event or None); host arrays are
        copied on the copy stream from pinned memory."""
        with span("gcv.predictor.stage"):
            ts = [torch.as_tensor(a) for a in arrays]
            if self.device.type != "cuda" or ts[0].is_cuda:
                return [t.to(self.device) for t in ts], None
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                ts = [t if t.is_cuda else t.pin_memory().to(self.device, non_blocking=True)
                      for t in ts]
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
            return ts, ready

    def _stream_launch(self, forward, ts: List[torch.Tensor],
                       ready: Optional["torch.cuda.Event"]) -> torch.Tensor:
        with span("gcv.predictor.launch"):
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                # the copy stream allocated them: keep them until this stream is done
                for t in ts:
                    t.record_stream(stream)
            return self._rows(forward(*ts))

    def predict_faces(self, faces_u8, num_frames: int) -> Tuple[int, float]:
        """faces_u8: [k,S,S,3] uint8 (numpy or a device tensor), k in
        [0, num_frames]; zero faces give the reference's default verdict
        without a device trip."""
        if len(faces_u8) == 0:
            return DEFAULT_VERDICT
        batch, mask = pad_faces(faces_u8, num_frames, self.config.img_size)
        with self.timers.stage("device_forward"):
            y, y_val = self.predict_videos_batched(batch[None], mask[None])
        return int(y[0]), float(y_val[0])

    def _native_fullframe(self) -> bool:
        """Whether the fullframe fast paths may run: the fullframe backend
        with native decode preferred (the library is asked separately)."""
        return isinstance(self.detector, FullFrameDetector) and self.prefer_native_decode

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _empty_faces(self) -> torch.Tensor:
        s = self.config.img_size
        return torch.zeros((0, s, s, 3), dtype=torch.uint8, device=self.device)

    def _detect_and_crop(self, frames: np.ndarray, num_frames: int,
                         detector: Optional[FaceDetector] = None) -> torch.Tensor:
        with self.timers.stage("detect"):
            x = self._upload(frames)
            boxes = (detector or self.detector).detect_many([frames], [x])[0]
        with self.timers.stage("crop"):
            return crop_faces(x, boxes, num_frames, self.config.img_size)

    def _detect_group(self, paths: Sequence[str], frames_list: List[np.ndarray],
                      device_frames: List[torch.Tensor]) -> List[List[List[Any]]]:
        """Boxes of several videos: one detect_many over all of them (from
        their frames on the device), or each video's recorded boxes."""
        if isinstance(self.detector, RecordedDetector):
            return [self.detector.for_video(os.path.basename(p)).detect(f)
                    for p, f in zip(paths, frames_list)]
        return self.detector.detect_many(frames_list, device_frames)

    def extract_faces(self, video_path: str, num_frames: int) -> torch.Tensor:
        """Decode + detect + crop of one video: uint8 faces [k,S,S,3] on
        the device, k <= num_frames. Fullframe with the native decoder:
        decoded straight to the model size, no detect or crop."""
        _maybe_inject_fault(video_path)
        if self._native_fullframe():
            try:
                if native.native_available():
                    s = self.config.img_size
                    with self.timers.stage("decode"):
                        r = native.NativeVideoReader(video_path, out_size=(s, s))
                        try:
                            frames = r.read_frames(sample_frame_indices(len(r), num_frames))
                        finally:
                            r.close()
                    return self._upload(frames) if len(frames) else self._empty_faces()
            except IOError:
                raise
            except Exception as e:
                # never silently: a decoder fault behind the generic path would
                # show only as lost throughput
                log.warning("native fast path failed on %s (%s: %s); using the generic "
                            "decode path", os.path.basename(video_path), type(e).__name__, e)
        with self.timers.stage("decode"):
            frames = extract_frames(video_path, num_frames, self.prefer_native_decode)
        if frames.size == 0:
            return self._empty_faces()
        det = self.detector
        if isinstance(det, RecordedDetector):
            det = det.for_video(os.path.basename(video_path))
        return self._detect_and_crop(frames, num_frames, det)

    def predict_video(self, video_path: str, num_frames: int = 15) -> Tuple[int, float]:
        return self.predict_faces(self.extract_faces(video_path, num_frames), num_frames)

    def extract_faces_from_frames_dir(self, frames_dir: str, num_frames: int) -> torch.Tensor:
        """Pre-extracted frame images in place of a video (ref
        predicition_video_format_error.py:16-23): the sorted image files,
        subsampled with the video frames' stepping."""
        import cv2

        from genconvit_tpu_torch.data.frames import sample_frame_indices

        names = sorted(f for f in os.listdir(frames_dir) if f.lower().endswith(_IMAGE_EXTS))
        frames = []
        for i in sample_frame_indices(len(names), num_frames):
            img = cv2.imread(os.path.join(frames_dir, names[i]), cv2.IMREAD_COLOR)
            if img is not None:
                frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        if not frames:
            return self._empty_faces()
        return self._detect_and_crop(np.stack(frames), num_frames)

    def predict_frames_dir(self, frames_dir: str, num_frames: int = 15) -> Tuple[int, float]:
        return self.predict_faces(self.extract_faces_from_frames_dir(frames_dir, num_frames),
                                  num_frames)

    def _extract_yuv(self, video_path: str, num_frames: int):
        """Fullframe YUV420 decode at the model size (:517-545 there): (y
        [F,S,S], u, v [F,S/2,S/2] uint8, affine [3,4], mask [F]) as numpy.
        The per-video affine carries the colour space and the range."""
        _maybe_inject_fault(video_path)
        s = self.config.img_size
        with self.timers.stage("decode"):
            r = native.NativeVideoReader(video_path, out_size=(s, s))
            try:
                y, u, v = r.read_frames_yuv(sample_frame_indices(len(r), num_frames))
                space, full = r.color_info()
            finally:
                r.close()
        k, f = min(len(y), num_frames), num_frames
        yb = np.zeros((f, s, s), np.uint8)
        ub = np.zeros((f, s // 2, s // 2), np.uint8)
        vb = np.zeros((f, s // 2, s // 2), np.uint8)
        yb[:k], ub[:k], vb[:k] = y[:k], u[:k], v[:k]
        mask = np.zeros((f,), np.float32)
        mask[:k] = 1.0
        return yb, ub, vb, yuv_affine(space, full), mask

    def predict_files_yuv(self, paths: Sequence[str], num_frames: int = 15,
                          workers: int = 8, video_batch: int = 16,
                          ) -> List[Tuple[str, Verdict]]:
        """Fullframe driver with the YUV420 transfer (:547-602 there): each
        video decoded to planes at the model size in the thread pool, in
        order of completion grouped into [V,F,...] plane batches (tail padded
        to video_batch) with one [3,4] transform a video, converted and
        scored by forward_batched_yuv; one fetch at the end. A decode error
        leaves None; a video without frames gets the (0, 0.5) default."""
        ordered: Dict[str, Verdict] = {p: None for p in paths}
        pending: List[Tuple[str, Tuple[np.ndarray, ...]]] = []
        names_per_launch: List[List[str]] = []
        launches: List[torch.Tensor] = []

        def flush():
            if pending:
                blocks = [self._upload(_pad_videos(np.stack([it[j] for _, it in pending]),
                                                   video_batch)) for j in range(5)]
                names_per_launch.append([p for p, _ in pending])
                launches.append(self._rows(self.forward_batched_yuv(*blocks)))
                pending.clear()

        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            futures = {ex.submit(self._extract_yuv, p, num_frames): p for p in paths}
            for fut in cf.as_completed(futures):
                p = futures[fut]
                try:
                    item = fut.result()
                except Exception as e:  # per-video tolerance
                    log.error("error on %s: %s", p, e)
                    continue
                if item[4].sum() == 0:
                    ordered[p] = DEFAULT_VERDICT
                    continue
                pending.append((p, item))
                if len(pending) >= video_batch:
                    flush()
        flush()
        self._fetch(names_per_launch, launches, ordered)
        return [(p, ordered[p]) for p in paths]

    def predict_files_native_rgb(self, paths: Sequence[str], num_frames: int = 15,
                                 video_batch: int = 8) -> List[Tuple[str, Verdict]]:
        """Fullframe RGB driver over the library's batch decoder (:604-651
        there): one decode_videos_batch call a group fills its [V,F,S,S,3]
        block at the model size; the launches are not synchronized, so the
        next group decodes while this one computes; one fetch at the end.
        A video the decoder cannot read (count 0) gets the (0, 0.5) default
        and takes no row of the launch."""
        s = self.config.img_size
        ordered: Dict[str, Verdict] = {p: None for p in paths}
        names_per_launch: List[List[str]] = []
        launches: List[torch.Tensor] = []
        for g in range(0, len(paths), video_batch):
            group = []
            for p in paths[g: g + video_batch]:
                try:  # per-video tolerance (ref prediction.py:25-45)
                    _maybe_inject_fault(p)
                    group.append(p)
                except Exception as e:
                    log.error("error on %s: %s", p, e)
            if not group:
                continue
            with self.timers.stage("decode"):
                frames, counts = native.decode_videos_batch(group, num_frames, s, s)
            for p, c in zip(group, counts):
                if c == 0:
                    ordered[p] = DEFAULT_VERDICT
            keep = np.flatnonzero(counts > 0)
            if len(keep) == 0:
                continue
            if len(keep) < len(group):
                frames, counts = frames[keep], counts[keep]
            masks = (np.arange(num_frames)[None, :] < counts[:, None]).astype(np.float32)
            names_per_launch.append([group[i] for i in keep])
            launches.append(self._rows(self.forward_batched(
                self._upload(_pad_videos(frames, video_batch)),
                self._upload(_pad_videos(masks, video_batch)))))
        self._fetch(names_per_launch, launches, ordered)
        return [(p, ordered[p]) for p in paths]

    def predict_files(self, paths: Sequence[str], num_frames: int = 15,
                      workers: int = 8, video_batch: int = 8,
                      ) -> List[Tuple[str, Verdict]]:
        """Batch driver: decode/detect/crop in a thread pool, videos grouped
        into [V,F,...] launches (tail padded to video_batch), one fetch at
        the end. A failed video yields None (per-video fault tolerance, ref
        prediction.py:25-45); a zero-face video the (0, 0.5) default without
        a device trip. Detector backends take the grouped driver
        (predict_files_group_detect) unless GENCONVIT_GROUP_DETECT=0. With
        the fullframe backend and the native decoder, several paths take
        predict_files_native_rgb, or predict_files_yuv (in groups of 16)
        under transfer_format='yuv420'; should that driver fail, the
        generic one runs."""
        if len(paths) > 1 and self._native_fullframe():
            try:
                if native.native_available():
                    if self.transfer_format == "yuv420":
                        return self.predict_files_yuv(paths, num_frames, workers)
                    return self.predict_files_native_rgb(paths, num_frames, video_batch)
            except Exception as e:
                log.warning("native batch path unavailable (%s); using the generic driver", e)
        if (len(paths) > 1 and not isinstance(self.detector, FullFrameDetector)
                and os.environ.get("GENCONVIT_GROUP_DETECT", "1") == "1"):
            return self.predict_files_group_detect(paths, num_frames, workers, video_batch)
        ordered: Dict[str, Verdict] = {p: None for p in paths}
        if not paths:
            return []
        pending: List[Tuple[str, torch.Tensor, torch.Tensor]] = []
        names_per_launch: List[List[str]] = []
        launches: List[torch.Tensor] = []

        def flush():
            if pending:
                names_per_launch.append([p for p, _, _ in pending])
                launches.append(self._launch([f for _, f, _ in pending],
                                             [m for _, _, m in pending], video_batch))
                pending.clear()

        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            futures = {ex.submit(self.extract_faces, p, num_frames): p for p in paths}
            for fut in cf.as_completed(futures):
                p = futures[fut]
                try:
                    faces = fut.result()
                except Exception as e:  # per-video tolerance
                    log.error("error on %s: %s", p, e)
                    continue
                if len(faces) == 0:
                    ordered[p] = DEFAULT_VERDICT
                elif len(paths) == 1:
                    ordered[p] = self.predict_faces(faces, num_frames)
                else:
                    pending.append((p, *pad_faces(faces, num_frames, self.config.img_size)))
                    if len(pending) >= video_batch:
                        flush()
        flush()
        self._fetch(names_per_launch, launches, ordered)
        return [(p, ordered[p]) for p in paths]

    def predict_files_group_detect(self, paths: Sequence[str], num_frames: int = 15,
                                   workers: int = 8, video_batch: int = 8,
                                   ) -> List[Tuple[str, Verdict]]:
        """Grouped driver for detector backends (:653-778 there): per group
        of video_batch videos, decode in the thread pool, one batched
        detect_many over the whole group, crops on the device, then the
        launch; group i+1 decodes while group i detects. One fetch syncs
        all."""
        ordered: Dict[str, Verdict] = {p: None for p in paths}
        names_per_launch: List[List[str]] = []
        launches: List[torch.Tensor] = []
        groups = [list(paths[g: g + video_batch]) for g in range(0, len(paths), video_batch)]
        ex = cf.ThreadPoolExecutor(max_workers=workers)
        try:
            self._group_detect_loop(groups, ex, num_frames, video_batch, ordered,
                                    names_per_launch, launches)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
        self._fetch(names_per_launch, launches, ordered)
        return [(p, ordered[p]) for p in paths]

    def _group_detect_loop(self, groups, ex, num_frames, video_batch, ordered,
                           names_per_launch, launches) -> None:
        """decode(i+1) runs in the pool while detect(i) runs as its own pool
        future and the main thread crops and launches group i-1, so the
        "decode" and "detect" timers measure the residual wait."""
        s = self.config.img_size

        def grab(p):
            _maybe_inject_fault(p)
            return extract_frames(p, num_frames, self.prefer_native_decode)

        def detect(det_items):
            # each video's frames go to the device once, for the detector's
            # windows and the crops alike
            dev = [self._upload(f) for _, f in det_items]
            return self._detect_group([p for p, _ in det_items],
                                      [f for _, f in det_items], dev), dev

        def crop_and_launch(det_items, boxes_fut):
            with self.timers.stage("detect"):  # residual wait only
                boxes_list, dev = boxes_fut.result()
            names, faces, masks = [], [], []
            with self.timers.stage("crop"):
                for (p, _), x, boxes in zip(det_items, dev, boxes_list):
                    crops = crop_faces(x, boxes, num_frames, s)
                    if len(crops) == 0:  # zero faces: the (0, 0.5) default (B2)
                        ordered[p] = DEFAULT_VERDICT
                        continue
                    batch, mask = pad_faces(crops, num_frames, s)
                    names.append(p)
                    faces.append(batch)
                    masks.append(mask)
            if names:
                names_per_launch.append(names)
                launches.append(self._launch(faces, masks, video_batch))

        next_futs = {p: ex.submit(grab, p) for p in groups[0]} if groups else {}
        pending = None  # (det_items, detect future) of group i-1
        for gi, group in enumerate(groups):
            cur_futs = next_futs
            if gi + 1 < len(groups):
                next_futs = {p: ex.submit(grab, p) for p in groups[gi + 1]}
            frames_map: Dict[str, np.ndarray] = {}
            with self.timers.stage("decode"):
                for p, fut in cur_futs.items():
                    try:  # per-video tolerance (ref prediction.py:25-45)
                        frames_map[p] = fut.result()
                    except Exception as e:
                        log.error("error on %s: %s", p, e)
            det_items = []
            for p in group:
                f = frames_map.get(p)
                if f is None:
                    continue  # decode error: stays None
                if f.size == 0:
                    ordered[p] = DEFAULT_VERDICT
                else:
                    det_items.append((p, f))
            det_fut = ex.submit(detect, det_items) if det_items else None
            if pending is not None:
                crop_and_launch(*pending)  # overlaps detect(i) in the pool
            pending = (det_items, det_fut) if det_fut is not None else None
        if pending is not None:
            crop_and_launch(*pending)

    def state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{'ed': ..., 'vae': ...} of the branches present, reference keys.
        Raises once the latent heads are int8: their float weights are gone."""
        if hasattr(self.model, "vae") and self.model.vae.encoder.heads_int8:
            raise RuntimeError("the VAE latent heads are int8 (int8_heads): the "
                               "branch no longer holds its float weights")
        return {name: getattr(self.model, name).state_dict()
                for name in ("ed", "vae") if hasattr(self.model, name)}
