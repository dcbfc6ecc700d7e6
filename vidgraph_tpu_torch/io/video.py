"""Video decode + chunking on the host (decode is not TPU-feasible), feeding
the device preprocessing kernel.

Chunk/time semantics match the reference (reference:
src/pipeline/vlm_extractor.py:32-119): chunks are ``chunk_size_seconds``
long, ``frames_per_chunk`` evenly spaced frames are taken per chunk, frames
larger than 720p are downscaled, and chunk time labels are
``MM:SS-MM:SS`` with an inclusive end second.  Unlike the reference's
seek-per-frame loop, frames are read with at most one seek per chunk.

Also provides a deterministic synthetic-video generator (colored moving
shapes over scene segments) so the full pipeline runs offline and tests can
assert on scene content.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..core.logger import get_logger

logger = get_logger("video_io")

MAX_DIM = 720  # match the reference's <=720p policy


@dataclasses.dataclass
class VideoMeta:
    path: str
    fps: float
    total_frames: int
    duration_seconds: float


def probe_video(path: str) -> VideoMeta:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return VideoMeta(path, float(fps), total,
                     total / fps if fps else 0.0)


def format_chunk_time(chunk_idx: int, chunk_size_seconds: float) -> str:
    start = int(chunk_idx * chunk_size_seconds)
    end = max(start, int((chunk_idx + 1) * chunk_size_seconds) - 1)

    def mmss(s: int) -> str:
        return f"{s // 60:02d}:{s % 60:02d}"

    return f"{mmss(start)}-{mmss(end)}"


def resize_max_dim(frame: np.ndarray, max_dim: int = MAX_DIM) -> np.ndarray:
    import cv2

    h, w = frame.shape[:2]
    m = max(h, w)
    if m <= max_dim:
        return frame
    scale = max_dim / m
    return cv2.resize(frame, (int(w * scale), int(h * scale)),
                      interpolation=cv2.INTER_AREA)


def iter_chunk_frames(path: str, chunk_size_seconds: float,
                      frames_per_chunk: int,
                      max_dim: int = MAX_DIM,
                      ) -> Iterator[Tuple[int, str, List[np.ndarray]]]:
    """Yield (chunk_idx, time_label, [RGB uint8 frames]) per chunk.

    One sequential pass: a single seek per chunk, then sequential reads
    (the reference seeks per frame — reference:
    src/pipeline/vlm_extractor.py:110-111).
    """
    import cv2

    meta = probe_video(path)
    frames_per_sec_chunk = int(meta.fps * chunk_size_seconds)
    if frames_per_sec_chunk <= 0:
        return
    total_chunks = max(1, meta.total_frames // frames_per_sec_chunk)
    cap = cv2.VideoCapture(path)
    try:
        for chunk_idx in range(total_chunks):
            base = chunk_idx * frames_per_sec_chunk
            n = min(frames_per_chunk, frames_per_sec_chunk)
            offsets = np.linspace(0, frames_per_sec_chunk - 1, n).astype(int)
            cap.set(cv2.CAP_PROP_POS_FRAMES, base)
            want = set(int(o) for o in offsets)
            frames: List[np.ndarray] = []
            for off in range(frames_per_sec_chunk):
                ok, frame = cap.read()
                if not ok:
                    break
                if off in want:
                    frame = resize_max_dim(frame, max_dim)
                    frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if frames:
                yield (chunk_idx,
                       format_chunk_time(chunk_idx, chunk_size_seconds),
                       frames)
    finally:
        cap.release()


def count_chunks(path: str, chunk_size_seconds: float) -> int:
    meta = probe_video(path)
    per = int(meta.fps * chunk_size_seconds)
    return max(1, meta.total_frames // per) if per > 0 else 0


# ---------------------------------------------------------------------------
# Synthetic video generation (offline tests / benchmarks)
# ---------------------------------------------------------------------------

_COLORS = {
    "red": (220, 40, 40), "green": (40, 200, 60), "blue": (40, 80, 220),
    "yellow": (230, 220, 40), "magenta": (210, 40, 200),
    "cyan": (40, 210, 210), "white": (240, 240, 240), "gray": (128, 128, 128),
}


def write_synthetic_video(path: str, scenes: Sequence[str],
                          seconds_per_scene: float = 5.0, fps: int = 10,
                          size: Tuple[int, int] = (240, 320),
                          motion: bool = True) -> str:
    """Write an mp4 of colored moving squares, one color per scene."""
    import cv2

    h, w = size
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(path),
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError("cv2.VideoWriter failed to open")
    try:
        for scene in scenes:
            rgb = _COLORS.get(scene, (128, 128, 128))
            bgr = (rgb[2], rgb[1], rgb[0])
            n = int(seconds_per_scene * fps)
            for i in range(n):
                frame = np.full((h, w, 3), 30, np.uint8)
                side = min(h, w) // 2
                if motion:
                    x = int((w - side) * (0.5 + 0.4 * np.sin(i / 5.0)))
                else:
                    x = (w - side) // 2
                y = (h - side) // 2
                frame[y:y + side, x:x + side] = bgr
                writer.write(frame)
    finally:
        writer.release()
    return str(path)
