from .video import (count_chunks, format_chunk_time, iter_chunk_frames,
                    probe_video, resize_max_dim, write_synthetic_video)

__all__ = ["count_chunks", "format_chunk_time", "iter_chunk_frames",
           "probe_video", "resize_max_dim", "write_synthetic_video"]
