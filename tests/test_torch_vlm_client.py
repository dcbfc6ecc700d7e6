"""The port's on-device vision stage against the JAX package's, on the CPU:
``models/captioner.py::generate``, ``TPUVLMClient``, ``VLMExtractor`` and
the CLI's ``vlm``.

Weights are the JAX package's (``init_params``, ``init_vision_tower``),
carried across by ``convert.py`` or written by its checkpoint writer as the
VLM npz ``{"vit": ..., "cap": ...}`` that both clients read.  Configs are
float32 (``tiny``, the ``tiny64`` preset), where the standard is the JAX
tests' own: greedy tokens, and so captions, equal.  Frames come from a
numpy seed or from the synthetic video of ``tests/test_tpu_vlm_path.py``.
"""
import asyncio
import json
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from vidgraph_tpu.cli.main import main as jax_cli  # noqa: E402
from vidgraph_tpu.core.config import PipelineConfig as JConfig  # noqa: E402
from vidgraph_tpu.io.video import write_synthetic_video  # noqa: E402
from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import checkpoint as jck  # noqa: E402
from vidgraph_tpu.pipeline.vlm_extractor import (  # noqa: E402
    VLMExtractor as JExtractor)
from vidgraph_tpu.services import vlm_client as jvc  # noqa: E402
from vidgraph_tpu_torch.cli.main import main as port_cli  # noqa: E402
from vidgraph_tpu_torch.convert import captioner_params_from_jax  # noqa: E402
from vidgraph_tpu_torch.core.config import (  # noqa: E402
    PipelineConfig as TConfig)
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models.quant8 import is_q8  # noqa: E402
from vidgraph_tpu_torch.pipeline.vlm_extractor import (  # noqa: E402
    VLMExtractor as TExtractor)
from vidgraph_tpu_torch.services import vlm_client as tvc  # noqa: E402

MAX_NEW = 24


def _port_cap_cfg(jcfg):
    return tcap.CaptionerConfig(
        width=jcfg.width, layers=jcfg.layers, heads=jcfg.heads,
        vocab=jcfg.vocab, vision_dim=jcfg.vision_dim,
        num_vision_tokens=jcfg.num_vision_tokens, max_len=jcfg.max_len,
        dtype=torch.float32)


def test_base_config():
    base = tcap.CaptionerConfig.base()
    jbase = jcap.CaptionerConfig.base()
    assert (base.width, base.layers, base.heads, base.max_len,
            base.num_vision_tokens, base.vision_dim) == (
        jbase.width, jbase.layers, jbase.heads, jbase.max_len,
        jbase.num_vision_tokens, jbase.vision_dim) == (512, 8, 8, 1024, 8,
                                                        512)
    assert base.dtype == torch.bfloat16
    assert base.num_params == jbase.num_params


@pytest.mark.parametrize("b,max_new", [(1, 20), (3, 40)])
def test_generate_tokens_equal(b, max_new):
    jcfg = jcap.CaptionerConfig.tiny()
    jp = jcap.init_params(jcfg, seed=b)
    tp = captioner_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    vis = np.random.default_rng(b).normal(
        size=(b, jcfg.num_vision_tokens, jcfg.vision_dim)).astype(
        np.float32)
    ref = np.asarray(jcap.generate(jp, jcfg, vis, max_new=max_new))
    got = tcap.generate(tp, _port_cap_cfg(jcfg), torch.from_numpy(vis),
                        max_new=max_new)
    assert got.dtype == torch.int32 and got.shape == (b, max_new)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_past_max_len_clamps_positions_as_jax():
    """``generate`` does not check its budget: positions past ``max_len``
    reuse the last embedding in both packages."""
    jcfg = jcap.CaptionerConfig.tiny()          # max_len 64
    jp = jcap.init_params(jcfg, seed=9)
    tp = captioner_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    vis = np.random.default_rng(9).normal(size=(2, 2, 32)).astype(
        np.float32)
    ref = np.asarray(jcap.generate(jp, jcfg, vis, max_new=80))
    got = tcap.generate(tp, _port_cap_cfg(jcfg), torch.from_numpy(vis),
                        max_new=80)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture(scope="module")
def vlm_npz(tmp_path_factory):
    """The tiny64 preset's weights, drawn by the JAX client and written by
    the JAX package's checkpoint writer."""
    jc = jvc.TPUVLMClient(preset="tiny64", seed=3)
    path = tmp_path_factory.mktemp("vlm") / "vlm.npz"
    jck.save_params({"vit": jc.vit_params, "cap": jc.cap_params}, str(path))
    return str(path)


def _chunks(shape, sizes, seed):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
            for n in sizes]


def _clients(npz, **kw):
    return (jvc.TPUVLMClient(preset="tiny64", checkpoint=npz,
                             max_new=MAX_NEW, **kw),
            tvc.TPUVLMClient(preset="tiny64", checkpoint=npz,
                             max_new=MAX_NEW, **kw))


def test_client_loads_the_npz_bit_for_bit(vlm_npz):
    jc, tc = _clients(vlm_npz)
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jc.vit_params)}
    for name, t in tc.vit.state_dict().items():
        np.testing.assert_array_equal(
            t.numpy(), flat["params/" + name.replace(".", "/")])
    np.testing.assert_array_equal(tc.cap_params["tok_emb"].numpy(),
                                  np.asarray(jc.cap_params["tok_emb"]))


@pytest.mark.parametrize("preprocess,fast,shape", [
    ("device", True, (96, 128, 3)),
    ("device", False, (96, 128, 3)),
    ("host", True, (120, 160, 3)),
    ("auto", True, (64, 64, 3)),
])
def test_client_captions_equal(vlm_npz, preprocess, fast, shape):
    """Chunks of 1, 4 and 6 frames (nv = 4: tiled, exact, cut) in one
    call, through each preprocessing path."""
    jc, tc = _clients(vlm_npz, preprocess=preprocess, fast_resize=fast)
    chunks = _chunks(shape, [1, 4, 6], seed=sum(shape))
    ref = jc.caption_batch_sync(chunks)
    got = tc.caption_batch_sync(chunks)
    assert got == ref and len(got) == 3


def test_quantize_raises():
    """``int8`` and ``int8_a8`` serve (mode a16 and a8, the block matrices
    and the head as ``Q8``); any other value raises ``ValueError``."""
    for quantize, qmode in (("int8", "a16"), ("int8_a8", "a8")):
        client = tvc.TPUVLMClient(preset="tiny64", quantize=quantize)
        assert client.quantize == quantize
        assert client.cap_cfg.qmode == qmode
        assert is_q8(client.cap_params["head_w"])
        assert is_q8(client._serve_params["blocks"][0]["qkv_w"])
    assert tvc.TPUVLMClient(preset="tiny64").quantize is None
    with pytest.raises(ValueError, match="int8|int8_a8"):
        tvc.TPUVLMClient(preset="tiny64", quantize="int4")


@pytest.fixture
def one_device_serving():
    """The JAX client ignores ``quantize`` under a serving mesh, and the
    tests' 8 virtual CPU devices build one: serve single-device."""
    from vidgraph_tpu.parallel import serving as jserving

    jserving.configure(enabled=False)
    yield
    jserving.configure(enabled="auto")


@pytest.mark.parametrize("quantize", ["int8", "int8_a8"])
def test_quantized_client_captions_equal(vlm_npz, one_device_serving,
                                         quantize):
    """Both clients quantise the same loaded weights; the captions of
    chunks of 1, 4 and 6 frames are equal."""
    jc, tc = _clients(vlm_npz, preprocess="device", quantize=quantize)
    assert tc.cap_cfg.qmode == jc.cap_cfg.qmode
    np.testing.assert_array_equal(
        tc.cap_params["blocks"][0]["fc1_w"].q.numpy(),
        np.asarray(jc.cap_params["blocks"][0]["fc1_w"].q))
    chunks = _chunks((96, 128, 3), [1, 4, 6], seed=11)
    ref = jc.caption_batch_sync(chunks)
    got = tc.caption_batch_sync(chunks)
    assert got == ref and len(got) == 3


def test_make_vlm_client_reads_the_config(vlm_npz):
    cfg = TConfig()
    cfg.vlm.checkpoint_path = vlm_npz
    cfg.vlm.tpu_preset = "tiny64"
    cfg.vlm.preprocess = "device"
    cfg.vlm.fast_resize = False
    client = tvc.make_vlm_client("tpu", cfg.vlm)
    assert isinstance(client, tvc.TPUVLMClient)
    assert (client.preprocess, client.fast_resize) == ("device", False)
    assert client.vit_cfg.image_size == 64 and client.max_new == 256
    assert isinstance(tvc.make_vlm_client("local"), tvc.LocalVLMClient)
    cfg.vlm.quantize = "int8_a8"
    quantised = tvc.make_vlm_client("tpu", cfg.vlm)
    assert quantised.quantize == "int8_a8"
    assert quantised.cap_cfg.qmode == "a8"
    cfg.vlm.quantize = "int4"
    with pytest.raises(ValueError):
        tvc.make_vlm_client("tpu", cfg.vlm)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    return write_synthetic_video(
        str(tmp_path_factory.mktemp("video") / "v.mp4"), ["red", "blue"],
        seconds_per_scene=1.0, fps=4, size=(64, 64))


def _strip(results):
    return [{k: r[k] for k in ("time", "chunk_idx", "content")}
            for r in results]


def test_extractor_results_equal(vlm_npz, video, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outs = []
    for cfg_cls, ext_cls, client in zip((JConfig, TConfig),
                                        (JExtractor, TExtractor),
                                        _clients(vlm_npz)):
        cfg = cfg_cls()
        cfg.video.chunk_size_seconds = 1.0
        cfg.video.frames_per_chunk = 2
        out = tmp_path / f"{cfg_cls.__module__.split('.')[0]}.json"
        asyncio.run(ext_cls(cfg, vlm_client=client).process_video(
            video, str(out)))
        outs.append(json.loads(out.read_text()))
    ref, got = outs
    assert set(got) == {"metadata", "results"}
    assert set(got["metadata"]) == {"run_id", "video_path", "total_chunks",
                                    "config"}
    assert got["metadata"]["total_chunks"] == len(got["results"]) == 2
    assert _strip(got["results"]) == _strip(ref["results"])
    assert all(r["processing_time"] > 0 for r in got["results"])


def test_cli_vlm_results_equal(vlm_npz, video, tmp_path, monkeypatch):
    """``vlm`` through each package's CLI, from one YAML: backend.vlm tpu
    with the tiny64 preset and the npz, the decode budget at its default
    256 (past the preset's max_len, as the JAX package allows)."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "backend": {"vlm": "tpu"},
        "video": {"chunk_size_seconds": 1.0, "frames_per_chunk": 2},
        "vlm": {"tpu_preset": "tiny64", "checkpoint_path": vlm_npz,
                "preprocess": "device"}}))
    for cli, name in ((jax_cli, "jax.json"), (port_cli, "port.json")):
        assert cli(["vlm", "--config", str(cfg), "--video", video,
                    "--output", name]) == 0
    ref = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert len(got["results"]) == 2
    assert _strip(got["results"]) == _strip(ref["results"])
    assert got["metadata"]["config"] == ref["metadata"]["config"]
    assert port_cli(["graph", "--config", str(cfg), "--video", video,
                     "--output", "alias.json"]) == 0
    assert _strip(json.loads((tmp_path / "alias.json").read_text())
                  ["results"]) == _strip(ref["results"])
