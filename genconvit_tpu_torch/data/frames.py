"""Frame sampling (copy of genconvit_tpu/data/frames.py): bit-matches the
reference's decord-based selection (ref model/pred_func.py:138-143):

    step = max(1, n_frames_total // num_frames)
    indices = list(range(0, n_frames_total, step))[:num_frames]
"""

from __future__ import annotations

from typing import List


def sample_frame_indices(n_total: int, num_frames: int) -> List[int]:
    if n_total <= 0:
        return []
    step = max(1, n_total // num_frames)
    return list(range(0, n_total, step))[:num_frames]
