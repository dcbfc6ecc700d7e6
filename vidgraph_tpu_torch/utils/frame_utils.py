"""Standalone frame utilities (reference: src/utils/frame_utils.py:8-64).

Parity surface: ``extract_keyframes`` (evenly spaced frames from a video),
``resize_frame`` (<=720p), ``frames_to_base64`` (JPEG-85).  The main
pipeline uses io.video + ops.preprocess; these helpers exist for users of
the reference API.
"""
from __future__ import annotations

import base64
from typing import List

import numpy as np

from ..io.video import resize_max_dim


def extract_keyframes(video_path: str, num_frames: int = 5,
                      max_dim: int = 720) -> List[np.ndarray]:
    """Evenly spaced RGB frames across the whole video."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            return []
        positions = np.linspace(0, total - 1, num_frames).astype(int)
        frames = []
        for pos in positions:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(pos))
            ok, frame = cap.read()
            if not ok:
                continue
            frame = resize_max_dim(frame, max_dim)
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        return frames
    finally:
        cap.release()


def resize_frame(frame: np.ndarray, max_dim: int = 720) -> np.ndarray:
    return resize_max_dim(frame, max_dim)


def frames_to_base64(frames: List[np.ndarray],
                     jpeg_quality: int = 85) -> List[str]:
    """RGB frames -> base64 JPEG strings."""
    import cv2

    out = []
    for frame in frames:
        bgr = cv2.cvtColor(np.asarray(frame), cv2.COLOR_RGB2BGR)
        ok, buf = cv2.imencode(
            ".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), jpeg_quality])
        if not ok:
            raise ValueError("JPEG encoding failed")
        out.append(base64.b64encode(buf.tobytes()).decode("ascii"))
    return out
