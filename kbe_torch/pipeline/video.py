"""Frame and video output. A copy of ``kbe_tpu/pipeline/video.py``: numpy
only, with imageio and cv2 imported inside the functions that need them, so
importing the module needs neither.

Host-side equivalent of the reference's frame dump and moviepy writer
(utils/pipeline.py:120-134): optional per-frame PNGs, then an mp4 of the
forward + reversed palindrome at 25 fps, written with imageio-ffmpeg, else
cv2, else as a PNG sequence.
"""

from __future__ import annotations

import os
import numpy as np


def write_frames(frames: np.ndarray, output_dir: str,
                 bgr_input: bool = True) -> None:
    """Dump frames as PNGs under ``output_dir``/frames
    (utils/pipeline.py:120-127). The reference writes with cv2.imwrite
    (expects BGR); imageio expects RGB, so BGR pipeline frames are flipped
    here to land identically on disk."""
    import imageio.v2 as iio

    frames_dir = os.path.join(output_dir, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    for idx, frame in enumerate(frames):
        out = frame[:, :, ::-1] if bgr_input else frame
        iio.imwrite(os.path.join(frames_dir, f"{idx}.png"),
                    out.astype(np.uint8))


def write_video(frames: np.ndarray, output_path: str, fps: int = 25,
                bgr_input: bool = True,
                palindrome: bool = True) -> str:
    """Write the palindrome mp4 (utils/pipeline.py:130-134).

    ``bgr_input=True`` flips channels to RGB for encoding (the reference
    flips with ``[:, :, ::-1]`` except in --pretrained-estim mode).
    Falls back to writing a PNG sequence if no ffmpeg backend exists.
    """
    seq = list(frames)
    if palindrome:
        seq = seq + list(frames[::-1][1:])
    seq = [f[:, :, ::-1] if bgr_input else f for f in seq]
    seq = [np.ascontiguousarray(f.astype(np.uint8)) for f in seq]

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    try:
        import imageio.v2 as iio

        writer = iio.get_writer(output_path, fps=fps)
        for f in seq:
            writer.append_data(f)
        writer.close()
        return output_path
    except Exception:
        pass
    try:
        import cv2

        h, w = seq[0].shape[:2]
        vw = cv2.VideoWriter(output_path,
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for f in seq:
                vw.write(f[:, :, ::-1])  # cv2 wants BGR
            vw.release()
            return output_path
    except Exception:
        # No ffmpeg: fall back to a PNG sequence next to the target.
        import imageio.v2 as iio

        seq_dir = output_path + ".frames"
        os.makedirs(seq_dir, exist_ok=True)
        for i, f in enumerate(seq):
            iio.imwrite(os.path.join(seq_dir, f"{i:04d}.png"), f)
        return seq_dir
