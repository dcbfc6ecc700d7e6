"""Traffic of kind ``ingest``: captioning of recorded video through
``TPUVLMClient``, closed loop with one client.

A call is the client's async ``caption`` where the mix has one chunk a
call (as ``VLMExtractor.process_video`` sends the ``vlm`` command's
backfill), and ``caption_batch`` where it has more (as the stream engine
sends the ready chunks of its streams); both are driven from one event
loop, and both run ``caption_batch_sync`` on the client's worker thread.

Set-up builds the client (its weights drawn from the seed by the port),
makes the mix's pool of chunks on the device and brings it to the host,
and makes one call to warm every shape the window uses.  The window makes
calls back to back, each on chunks drawn from the seed out of the pool,
until ``seconds`` have passed; the call in flight then completes and
counts.  ``caption_chunks_per_s`` is every chunk captioned over the time
from the first dispatch to the end of the last call.

What the calls produced is captured where the client hands it on: the
frames out of ``ops.preprocess.preprocess_frames`` for rows drawn from the
seed before each call, and each call's vision prefix and tokens at
``models.captioner.generate``.  After the window the reference works out
the compared rows again from the raw frames and the seed, in float32:
``frames_err`` (largest |difference| of the normalised frames),
``prefix_err`` (largest relative l2 difference of a chunk's prefix),
``token_gap`` (largest gap by which a served byte's logit lies below the
reference's best, teacher-forced on the served bytes) and
``served_mismatch`` (compared rows whose returned caption is not the text
of their tokens).
"""
from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import compare, generate
from .trace import DeviceTrace, SetupClock, Spans

_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _port_configs(config: Dict):
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig
    from vidgraph_tpu_torch.models.vit import ViTConfig

    def kwargs(sizes):
        return {k: v for k, v in sizes.items() if k != "param_dtype"}

    vit = dict(kwargs(config["vit"]), dtype=_TYPES[config["vit"]["dtype"]])
    cap = dict(kwargs(config["captioner"]),
               dtype=_TYPES[config["captioner"]["dtype"]])
    return ViTConfig(**vit), CaptionerConfig(**cap)


class Capture:
    """What the client's calls produced, for the rows drawn per call."""

    def __init__(self, frames_per_chunk: int) -> None:
        self.f = frames_per_chunk
        self.rows: Optional[List[int]] = None
        self.calls: List[Dict] = []
        self._undo = []

    def install(self) -> None:
        from vidgraph_tpu_torch.models import captioner
        from vidgraph_tpu_torch.ops import preprocess

        pre, gen = preprocess.preprocess_frames, captioner.generate

        def preprocess_frames(frames_u8, *args, **kwargs):
            out = pre(frames_u8, *args, **kwargs)
            if self.rows is not None:
                self.calls[-1]["frames"] = {
                    r: out[r * self.f:(r + 1) * self.f].clone()
                    for r in self.rows if (r + 1) * self.f <= len(out)}
            return out

        def generate_(params, cfg, vision_emb, *args, **kwargs):
            toks = gen(params, cfg, vision_emb, *args, **kwargs)
            if self.rows is not None:
                self.calls[-1]["prefix"] = vision_emb.float().clone()
                self.calls[-1]["tokens"] = toks
            return toks

        preprocess.preprocess_frames = preprocess_frames
        captioner.generate = generate_
        self._undo = [(preprocess, "preprocess_frames", pre),
                      (captioner, "generate", gen)]

    def restore(self) -> None:
        for owner, attr, original in self._undo:
            setattr(owner, attr, original)
        self._undo = []

    def begin(self, order: np.ndarray, rows: List[int]) -> None:
        self.rows = rows
        self.calls.append({"order": order, "rows": rows})

    def end(self, texts: List[str]) -> None:
        call = self.calls[-1]
        call["texts"] = texts
        for key in ("prefix", "tokens"):
            if key in call:
                call[key] = call[key].cpu()
        call["frames"] = {r: f.cpu() for r, f in
                          call.get("frames", {}).items()}
        self.rows = None


def _instrument(spans: Spans, client) -> None:
    from vidgraph_tpu_torch.models import captioner

    spans.wrap(client, "caption_batch_sync", "vlm.caption_batch")
    spans.wrap(client, "host_frames", "vlm.host_frames")
    spans.wrap(client, "embed_frames", "vlm.embed_frames")
    spans.wrap(client, "vision_prefixes", "vlm.vision_prefixes")
    spans.wrap(captioner, "generate", "vlm.generate")


def _caller(client):
    """``call(chunks) -> texts`` through the client's async calls on one
    event loop, and the loop's closing."""
    loop = asyncio.new_event_loop()

    def call(chunks):
        if len(chunks) == 1:
            return [loop.run_until_complete(client.caption(chunks[0]))]
        return loop.run_until_complete(client.caption_batch(chunks))

    def close():
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
    return call, close


def run(cell, seed: int, seconds: float, trace: bool,
        clock: SetupClock, device: torch.device, keep: bool = False) -> Dict:
    """One run of the cell; ``keep`` also returns the captured calls and
    the pool, for the control's readings."""
    from vidgraph_tpu_torch.models.captioner import decode_steps
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    mix, conf = cell.traffic, cell.config
    vit_cfg, cap_cfg = _port_configs(conf)
    serving = conf["serving"]
    clock.mark("imports")
    client = TPUVLMClient(
        vit_cfg, cap_cfg, seed=seed, max_new=mix["max_new"],
        preprocess=serving["preprocess"], fast_resize=serving["fast_resize"],
        param_dtype=_TYPES[conf["captioner"]["param_dtype"]])
    clock.mark("weights")
    pool = generate.frame_pool(mix, seed, device)
    clock.mark("frames")
    orders = generate.call_order(seed, mix["pool_chunks"],
                                 mix["chunks_per_call"])
    pick = np.random.default_rng([int(seed) % (1 << 63), 2])
    call, close = _caller(client)
    call(generate.rows_of(pool, next(orders)))

    capture = Capture(mix["frames_per_chunk"])
    spans = Spans()
    dtrace = DeviceTrace() if trace else None
    capture.install()
    if trace:
        _instrument(spans, client)
    attempted = failed = 0
    call_s: List[float] = []
    setup_s = clock.stop()
    t0 = time.perf_counter()
    try:
        while True:
            t = time.perf_counter()
            # a traced run profiles one call after the window's time, so
            # that the profiler's cost to the host touches no timed span
            profiled = trace and t - t0 >= seconds
            order = next(orders)
            chunks = generate.rows_of(pool, order)
            rows = sorted(pick.choice(
                len(order), min(mix["sample_rows_per_call"], len(order)),
                replace=False).tolist())
            capture.begin(order, rows)
            if profiled:
                spans.timing = False
                with dtrace.record():
                    texts = call(chunks)
            else:
                texts = call(chunks)
            capture.end(texts)
            call_s.append(time.perf_counter() - t)
            attempted += len(order)
            failed += len(order) - sum(isinstance(t, str) for t in texts)
            if profiled or (not trace
                            and time.perf_counter() - t0 >= seconds):
                break
        elapsed = time.perf_counter() - t0
    finally:
        spans.restore()
        capture.restore()
        close()
    steps = [decode_steps(c["tokens"], mix["max_new"])
             for c in capture.calls if "tokens" in c]
    # the spans time the calls before the profiled one
    timed = steps[:-1] if trace else steps
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del client
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cell, seed, pool, capture.calls, device)
    out = {"setup_s": setup_s, "attempted": attempted, "failed": failed,
           "end_to_end": {"caption_chunks_per_s": attempted / elapsed,
                          "setup_s": setup_s},
           "memory_peak_bytes": peak, "numbers": numbers,
           "spans": dict(spans.seconds), "trace": dtrace,
           "counters": {"calls": len(capture.calls), "call_s": call_s,
                        "chunks_per_call": mix["chunks_per_call"],
                        "decode_steps": timed,
                        "traced_steps": steps[-1] if trace and steps else 0,
                        "window_s": elapsed}}
    if keep:
        out.update(calls=capture.calls, pool=pool)
    return out


def _prefix(emb: torch.Tensor, nv: int) -> torch.Tensor:
    """A chunk's nv vision slots from its frames' embeddings: the first nv
    frames, or the frames repeated in order when there are fewer."""
    reps = -(-nv // emb.shape[0])
    return emb.repeat(reps, 1)[:nv]


def reference_rows(cell, seed: int, pool: np.ndarray, calls: List[Dict],
                   device: torch.device, rnds=("float32",)):
    """For every compared row of the captured calls: (call, row, the
    reference's {rounding: (frames, prefix, logits)}), the logits
    teacher-forced on the row's served tokens.  The compared rows are the
    call's drawn rows and its longest caption."""
    from ..reference import captioner as ref_cap
    from ..reference import lowp
    from ..reference import preprocess as ref_pre
    from ..reference import vit as ref_vit

    lowp.no_tf32()
    conf, mix = cell.config, cell.traffic
    vs, cs = conf["vit"], conf["captioner"]
    eos, bos = mix["eos_id"], mix["bos_id"]
    tower = ref_vit.init_tower(vs, seed, device)
    cap = ref_cap.init_params(cs, seed, cs["param_dtype"], device)
    with torch.no_grad():
        for call in calls:
            toks = call.get("tokens")
            if toks is None or "prefix" not in call:
                yield call, None, None
                continue
            longest = max(range(len(toks)), key=lambda r: compare.
                          served_length(toks[r], eos))
            for r in sorted(set(call["rows"]) | {longest}):
                if r >= len(toks) or r >= len(call["texts"]):
                    yield call, r, None
                    continue
                raw = torch.from_numpy(pool[call["order"][r]]).to(device)
                n = compare.served_length(toks[r], eos)
                served = toks[r][:n].to(device).long()
                inputs = torch.cat([torch.tensor([bos], device=device),
                                    served[:-1]])[None]
                out = {}
                for name in rnds:
                    rnd = lowp.rounding(name)
                    img = ref_pre.preprocess(raw, vs["image_size"], rnd)
                    pre = _prefix(ref_vit.tower(tower, vs, img, rnd),
                                  cs["num_vision_tokens"])
                    logits = ref_cap.forward(cap, cs, pre[None], inputs,
                                             rnd)[0]
                    out[name] = (img, pre, logits)
                yield call, r, out


def check(cell, seed: int, pool: np.ndarray, calls: List[Dict],
          device: torch.device) -> Dict[str, float]:
    """The program's compared numbers against the float32 reference."""
    mix = cell.traffic
    eos = mix["eos_id"]
    nums = {"frames_err": 0.0, "prefix_err": 0.0, "token_gap": 0.0,
            "served_mismatch": 0.0}
    compared = missing = 0
    for call, r, ref in reference_rows(cell, seed, pool, calls, device):
        if ref is None:
            nums["served_mismatch"] += 1
            continue
        img, pre, logits = ref["float32"]
        if r in call["rows"]:
            got = call["frames"].get(r)
            if got is None:
                missing += 1
            else:
                nums["frames_err"] = max(nums["frames_err"], float(
                    (got.to(device).float() - img).abs().max()))
        got = call["prefix"][r].to(device)
        nums["prefix_err"] = max(nums["prefix_err"], float(
            (got - pre).norm() / pre.norm()))
        toks = call["tokens"][r]
        served = toks[:compare.served_length(toks, eos)].to(device)
        nums["token_gap"] = max(nums["token_gap"], float(
            compare.token_gaps(logits, served).max()))
        compared += len(served)
        if call["texts"][r] != compare.decode_bytes(toks.tolist(), eos):
            nums["served_mismatch"] += 1
    if compared == 0:
        nums["token_gap"] = float("nan")
    if missing:
        nums["frames_err"] = float("nan")
    return nums


def control(cell, seed: int, out: Dict, device: torch.device,
            lower: str = "fp8") -> Dict[str, float]:
    """The control's readings of the same numbers: the reference computed
    in ``lower`` precision in the program's place, against the float32
    reference, on the rows and served tokens of ``out``, a run's output
    kept with ``keep``.  Its token gap is that of the token the lower
    precision puts first at each position."""
    nums = {"frames_err": 0.0, "prefix_err": 0.0, "token_gap": 0.0}
    for call, r, ref in reference_rows(cell, seed, out["pool"], out["calls"],
                                       device, ("float32", lower)):
        if ref is None:
            continue
        img, pre, logits = ref["float32"]
        low_img, low_pre, low_logits = ref[lower]
        nums["frames_err"] = max(nums["frames_err"], float(
            (low_img - img).abs().max()))
        nums["prefix_err"] = max(nums["prefix_err"], float(
            (low_pre - pre).norm() / pre.norm()))
        first = low_logits.argmax(dim=-1)
        nums["token_gap"] = max(nums["token_gap"], float(
            compare.token_gaps(logits, first).max()))
    return nums
