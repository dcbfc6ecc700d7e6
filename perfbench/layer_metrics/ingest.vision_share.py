"""Share of a call's time spent in the vision tower: the spans around
``TPUVLMClient.embed_frames`` (upload, preprocessing, the tower) and
``vision_prefixes``, over the span around ``caption_batch_sync``, summed
over the window's untraced calls.  Moves ``caption_chunks_per_s``."""


def read(ctx):
    spans = ctx["spans"]
    total = sum(spans.get("vlm.caption_batch", []))
    vision = (sum(spans.get("vlm.embed_frames", []))
              + sum(spans.get("vlm.vision_prefixes", [])))
    if total <= 0 or vision <= 0:
        return None
    return 100.0 * vision / total
