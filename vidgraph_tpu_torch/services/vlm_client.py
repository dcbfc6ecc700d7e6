"""VLM captioning clients: the stage that turns a chunk of frames into text.

Counterpart of ``vidgraph_tpu/services/vlm_client.py``:

* ``TPUVLMClient`` (the JAX package's name, kept so that ``backend.vlm:
  tpu`` selects it): frames -> preprocessing (``ops/preprocess.py``, the
  CUDA kernel on the card) -> the ViT vision tower (``models/vit.py``) ->
  the captioner's greedy decode (``models/captioner.py::generate``, the
  flash kernel for its prefill), on ``core.platform.device()``.  All the
  frames of a call go through the tower at once, and all its chunks
  decode in one ``generate``.  The JAX package's power-of-two frame and
  batch buckets are dropped: they bounded XLA compiles, and their padded
  rows never reach an output.
* ``HttpVLMClient``: the OpenAI multi-image chat-completions call (JPEG-85
  base64 frames, 3 retries, linear backoff), as in the JAX package.
* ``LocalVLMClient``: the deterministic caption from frame statistics, as
  in the JAX package.
"""
from __future__ import annotations

import asyncio
import base64
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import profiling
from ..core.logger import get_logger

logger = get_logger("vlm_client")


class VLMClient:
    async def caption(self, frames: Sequence[np.ndarray],
                      system_prompt: str = "",
                      user_prompt: str = "") -> str:
        raise NotImplementedError

    async def caption_batch(self, chunks: Sequence[Sequence[np.ndarray]],
                            system_prompt: str = "",
                            user_prompt: str = "") -> List[str]:
        """Caption many chunks; backends override with true batching."""
        return list(await asyncio.gather(*[
            self.caption(frames, system_prompt, user_prompt)
            for frames in chunks]))


_TPU_VLM_PRESETS = {
    # name -> (ViTConfig kwargs, CaptionerConfig kwargs)
    "b32": ({}, {}),
    "tiny64": (dict(image_size=64, patch_size=32, width=128, layers=4,
                    heads=4, embed_dim=64),
               dict(width=128, layers=4, heads=4, vision_dim=64,
                    num_vision_tokens=4, max_len=104)),
}


class TPUVLMClient(VLMClient):
    """On-device captioning.  Weights are drawn from ``seed`` or loaded
    from ``checkpoint``, an npz in the JAX package's format holding
    ``{"vit": <Flax tree>, "cap": <captioner tree>}``.  ``preprocess``
    (auto | host | device) and ``fast_resize`` pin the preprocessing
    numerics as in the JAX package.  ``quantize`` (int8 | int8_a8)
    serves the captioner's block matrices and head as int8
    (``models/quant8.py``), quantised after the checkpoint load, with
    ``wdot`` in mode ``a16`` or ``a8``; ``param_dtype=torch.bfloat16``
    draws the matrices in bfloat16, which ``CaptionerConfig.large()``
    needs."""

    def __init__(self, vit_cfg=None, cap_cfg=None, seed: int = 0,
                 max_new: int = 256,
                 checkpoint: Optional[str] = None,
                 preset: Optional[str] = None,
                 preprocess: str = "auto",
                 fast_resize: bool = True,
                 param_dtype=None,
                 quantize: Optional[str] = None) -> None:
        from ..core.platform import device
        from ..models.captioner import (CaptionerConfig, init_params,
                                        serving_params)
        from ..models.vit import (ViTConfig, init_vision_tower, param_tree,
                                  state_dict_from_tree)

        if quantize and quantize not in ("int8", "int8_a8"):
            raise ValueError(f"quantize must be int8|int8_a8, "
                             f"got {quantize!r}")
        if preprocess not in ("auto", "host", "device"):
            raise ValueError(f"preprocess must be auto|host|device, "
                             f"got {preprocess!r}")
        self.device = device()
        if preset:
            vkw, ckw = _TPU_VLM_PRESETS[preset]
            vit_cfg = vit_cfg or ViTConfig(dtype=torch.float32, **vkw)
            cap_cfg = cap_cfg or CaptionerConfig(dtype=torch.float32, **ckw)
        self.vit_cfg = vit_cfg or ViTConfig.b32()
        self.cap_cfg = cap_cfg or CaptionerConfig.base()
        self.vit = init_vision_tower(self.vit_cfg, seed,
                                     device=self.device).eval()
        self.cap_params = init_params(self.cap_cfg, seed,
                                      param_dtype=param_dtype
                                      or torch.float32, device=self.device)
        if checkpoint:
            from ..models.checkpoint import load_params

            loaded = load_params({"vit": param_tree(self.vit),
                                  "cap": self.cap_params}, checkpoint)
            self.vit.load_state_dict(state_dict_from_tree(loaded["vit"]))
            self.cap_params = loaded["cap"]
            logger.info("Loaded VLM weights from %s", checkpoint)
        # Tensor-parallel serving: with a serving mesh active
        # (parallel/serving.py) the tower and the captioner keep this
        # rank's slices, and the tower and generate calls below run
        # inside the mesh.
        from ..parallel.serving import (serving_mesh, shard_captioner_params,
                                        shard_vit_params)

        self._mesh = serving_mesh()
        if self._mesh is not None:
            shard_vit_params(self.vit, self._mesh)
            self.cap_params = shard_captioner_params(
                self.cap_params, self._mesh, heads=self.cap_cfg.heads)
        # Weight-only int8 serving, applied after the checkpoint load; a
        # tensor-parallel mesh's slices are float, so it is ignored there,
        # as in the JAX package.
        if quantize and self._mesh is not None:
            logger.warning("quantize=%s ignored: a tensor-parallel "
                           "serving mesh is active", quantize)
            quantize = None
        if quantize:
            import dataclasses

            from ..models.quant8 import quantize_captioner_params

            self.cap_params = quantize_captioner_params(self.cap_params)
            self.cap_cfg = dataclasses.replace(
                self.cap_cfg, qmode="a8" if quantize == "int8_a8" else "a16")
        self.quantize = quantize
        # the matrices cast to the compute dtype once (same outputs)
        self._serve_params = serving_params(self.cap_params, self.cap_cfg)
        self.max_new = max_new
        self.preprocess = preprocess
        self.fast_resize = fast_resize
        self._preproc_logged = False

    async def caption(self, frames, system_prompt="", user_prompt="") -> str:
        with profiling.span("vlm.caption"):
            return (await asyncio.to_thread(self.caption_batch_sync,
                                            [list(frames)]))[0]

    async def caption_batch(self, chunks, system_prompt="",
                            user_prompt="") -> List[str]:
        with profiling.span("vlm.caption"):
            return await asyncio.to_thread(
                self.caption_batch_sync, [list(c) for c in chunks])

    def _chunk_prefix(self, emb: torch.Tensor) -> torch.Tensor:
        """[n_frames, d] frame embeddings -> [nv, d] vision prefix: the
        first nv frames, or the frames tiled when there are fewer."""
        nv = self.cap_cfg.num_vision_tokens
        n = emb.shape[0]
        if n >= nv:
            return emb[:nv]
        return emb.repeat(-(-nv // n), 1)[:nv]

    def host_frames(self, chunks: List[List[np.ndarray]]) -> np.ndarray:
        """All the chunks' frames stacked [n, H, W, 3] uint8, resized on
        the host with cv2 ``INTER_AREA`` when ``preprocess`` asks for it
        (``auto``: frames over 4x the tower's input, if cv2 imports)."""
        stack = np.concatenate([np.stack(c).astype(np.uint8)
                                for c in chunks], axis=0)
        size = self.vit_cfg.image_size
        big = stack.shape[1] * stack.shape[2] > 4 * size * size
        use_host = (self.preprocess == "host"
                    or (self.preprocess == "auto" and big))
        if use_host:
            try:
                import cv2

                stack = np.stack([
                    cv2.resize(f, (size, size),
                               interpolation=cv2.INTER_AREA)
                    for f in stack]).astype(np.uint8)
            except ImportError:
                if self.preprocess == "host":
                    raise RuntimeError(
                        "vlm.preprocess='host' requires cv2 (opencv)")
                use_host = False
        if not self._preproc_logged:
            logger.info(
                "VLM preprocess path: %s resize, device %s "
                "(vlm.preprocess=%s, vlm.fast_resize=%s)",
                "host cv2 INTER_AREA" if use_host else "device",
                "bf16 separable" if self.fast_resize else "exact f32",
                self.preprocess, self.fast_resize)
            self._preproc_logged = True
        return stack

    @torch.no_grad()
    def embed_frames(self, stack: np.ndarray) -> torch.Tensor:
        """[n, H, W, 3] uint8 frames -> [n, embed_dim] float32 embeddings
        on the device: one upload, one preprocessing launch, one tower
        call."""
        from ..ops.preprocess import preprocess_frames

        x = torch.from_numpy(np.ascontiguousarray(stack)).to(self.device)
        from ..parallel.serving import maybe_mesh

        x = preprocess_frames(x, size=self.vit_cfg.image_size,
                              fast=self.fast_resize)
        with maybe_mesh(self._mesh):
            return self.vit(x)

    def vision_prefixes(self, chunks: List[List[np.ndarray]],
                        emb: torch.Tensor) -> torch.Tensor:
        """[n_chunks, nv, embed_dim]: each chunk's prefix from its frames'
        rows of ``emb``."""
        prefixes, off = [], 0
        for c in chunks:
            prefixes.append(self._chunk_prefix(emb[off:off + len(c)]))
            off += len(c)
        return torch.stack(prefixes)

    def caption_batch_sync(self, chunks: List[List[np.ndarray]]
                           ) -> List[str]:
        """Every chunk's frames through the vision tower in one call, and
        every caption in one batched ``generate``."""
        from ..models import tokenizer
        from ..models.captioner import generate
        from ..parallel.serving import maybe_mesh

        with profiling.span("vlm.caption_batch") as sp:
            sp.set("chunks", len(chunks))
            with profiling.span("vlm.host_frames"):
                stack = self.host_frames(chunks)
            sp.set("frames", len(stack))
            with profiling.span("vlm.embed_frames"):
                emb = self.embed_frames(stack)
            with profiling.span("vlm.vision_prefixes"):
                vis = self.vision_prefixes(chunks, emb)
            with maybe_mesh(self._mesh):
                toks = generate(self._serve_params, self.cap_cfg, vis,
                                max_new=self.max_new)
            with profiling.span("vlm.tokens_to_host"):
                toks = toks.cpu().numpy()
                return [tokenizer.decode(toks[i])
                        for i in range(len(chunks))]


class HttpVLMClient(VLMClient):
    def __init__(self, endpoint: str, model: str, api_key: str = "",
                 temperature: float = 0.2, top_p: float = 0.9,
                 max_tokens: int = 2048, timeout: float = 180.0,
                 retries: int = 3, jpeg_quality: int = 85) -> None:
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.endswith("/chat/completions"):
            self.endpoint += "/chat/completions"
        self.model = model
        self.api_key = api_key
        self.temperature = temperature
        self.top_p = top_p
        self.max_tokens = max_tokens
        self.timeout = timeout
        self.retries = retries
        self.jpeg_quality = jpeg_quality

    @staticmethod
    def _to_b64_jpeg(frame: np.ndarray, quality: int) -> str:
        import cv2

        ok, buf = cv2.imencode(".jpg", frame,
                               [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        if not ok:
            raise ValueError("JPEG encoding failed")
        return base64.b64encode(buf.tobytes()).decode("ascii")

    async def caption(self, frames, system_prompt="", user_prompt="") -> str:
        import httpx

        content = [{"type": "text", "text": user_prompt or
                    "Describe what's happening in these frames from a video."}]
        for f in frames:
            b64 = self._to_b64_jpeg(np.asarray(f), self.jpeg_quality)
            content.append({
                "type": "image_url",
                "image_url": {"url": f"data:image/jpeg;base64,{b64}"},
            })
        messages = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": content})
        payload = {"model": self.model, "messages": messages,
                   "temperature": self.temperature, "top_p": self.top_p,
                   "max_tokens": self.max_tokens}
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        last: Optional[Exception] = None
        async with httpx.AsyncClient(timeout=self.timeout) as client:
            for attempt in range(self.retries):
                try:
                    r = await client.post(self.endpoint, json=payload,
                                          headers=headers)
                    r.raise_for_status()
                    return r.json()["choices"][0]["message"]["content"]
                except Exception as e:
                    last = e
                    logger.warning("VLM attempt %d failed: %s",
                                   attempt + 1, e)
                    await asyncio.sleep(1.0 * (attempt + 1))
        raise RuntimeError(f"VLM captioning failed: {last}")


_HUES = [(0, "red"), (30, "orange"), (60, "yellow"), (120, "green"),
         (180, "cyan"), (240, "blue"), (300, "magenta"), (360, "red")]


def _dominant_color(frame: np.ndarray) -> str:
    f = frame.astype(np.float32) / 255.0
    r, g, b = f[..., 0].mean(), f[..., 1].mean(), f[..., 2].mean()
    mx, mn = max(r, g, b), min(r, g, b)
    if mx - mn < 0.08:
        v = (r + g + b) / 3
        return "white" if v > 0.7 else ("black" if v < 0.2 else "gray")
    if mx == r:
        h = 60 * (((g - b) / (mx - mn)) % 6)
    elif mx == g:
        h = 60 * ((b - r) / (mx - mn) + 2)
    else:
        h = 60 * ((r - g) / (mx - mn) + 4)
    return min(_HUES, key=lambda hv: abs(hv[0] - h))[1]


class LocalVLMClient(VLMClient):
    """Deterministic frame-statistics captioner for offline runs/tests."""

    async def caption(self, frames, system_prompt="", user_prompt="") -> str:
        frames = [np.asarray(f) for f in frames]
        color = _dominant_color(frames[0])
        brightness = float(np.mean([f.mean() for f in frames]) / 255.0)
        motion = 0.0
        if len(frames) > 1:
            diffs = [np.abs(frames[i + 1].astype(np.int16)
                            - frames[i].astype(np.int16)).mean()
                     for i in range(len(frames) - 1)]
            motion = float(np.mean(diffs) / 255.0)
        level = "bright" if brightness > 0.6 else (
            "dark" if brightness < 0.25 else "evenly lit")
        activity = "rapid movement" if motion > 0.08 else (
            "slight movement" if motion > 0.01 else "a static scene")
        return (f"The scene shows a {color} object on a {level} background. "
                f"The frames contain {activity}. A {color} shape dominates "
                f"the view across {len(frames)} frames.")


def make_vlm_client(kind: str, vlm_config=None) -> VLMClient:
    if kind == "tpu":
        ckpt = getattr(vlm_config, "checkpoint_path", None) \
            if vlm_config is not None else None
        preset = getattr(vlm_config, "tpu_preset", None) \
            if vlm_config is not None else None
        pre = getattr(vlm_config, "preprocess", "auto") \
            if vlm_config is not None else "auto"
        fast = getattr(vlm_config, "fast_resize", True) \
            if vlm_config is not None else True
        quant = getattr(vlm_config, "quantize", None) \
            if vlm_config is not None else None
        return TPUVLMClient(checkpoint=ckpt, preset=preset,
                            preprocess=pre, fast_resize=fast,
                            quantize=quant)
    if kind == "local":
        return LocalVLMClient()
    if kind == "http":
        c = vlm_config
        return HttpVLMClient(c.endpoint, c.model_name, c.api_key,
                             temperature=c.temperature, top_p=c.top_p,
                             max_tokens=c.max_tokens)
    raise ValueError(f"unknown vlm backend: {kind}")
