from .embedding_utils import EmbeddingUtils
from .frame_utils import extract_keyframes, frames_to_base64, resize_frame

__all__ = ["EmbeddingUtils", "extract_keyframes", "frames_to_base64",
           "resize_frame"]
