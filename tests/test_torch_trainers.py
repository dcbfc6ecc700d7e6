"""The port's trainer scripts (``scripts/train_torch_*.py``) on the CPU,
against the JAX package's (``scripts/train_*.py``, imported by path).

* ``tokenize_examples`` and ``pack_corpus`` give arrays equal to the JAX
  scripts' on the golden vlm output plus synthetic sentences (the code of
  ``models/instruct_data.py``, which makes the dataset, is a copy).
* The instruct loss and one clipped, scheduled AdamW update from the same
  weights and batch: within 1e-5 of the JAX script's ``train_step``
  arithmetic (its ``loss_fn`` and ``optax.chain``, written out here since
  the script builds them inside ``main``).
* Each trainer's ``main([... "--device", "cpu"])`` runs at its smoke size
  in a temp dir: the loss falls, the npz loads with the JAX package's
  ``load_params`` bit for bit, ``--resume`` continues from the saved step,
  and the checkpoint serves through the port's ``generate_from_tokens``.
"""
import importlib.util
import json
import os
import random
from pathlib import Path

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import checkpoint as jck  # noqa: E402
from vidgraph_tpu.models import instruct_data as jdata  # noqa: E402
from vidgraph_tpu.models import tokenizer as jtok  # noqa: E402
from vidgraph_tpu.models import vit as jvit  # noqa: E402
from vidgraph_tpu_torch.convert import captioner_params_from_jax  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402
from vidgraph_tpu_torch.models import instruct_data as tdata  # noqa: E402
from vidgraph_tpu_torch.models import tokenizer as ttok  # noqa: E402
from vidgraph_tpu_torch.models import train as ttrain  # noqa: E402

ROOT = Path(__file__).parent.parent
GOLDEN = ROOT / "tests" / "golden" / "vlm_output_golden.json"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in (
        "train_instruct_lm", "train_midscale", "train_torch_instruct_lm",
        "train_torch_midscale", "train_torch_captioner")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    """The golden vlm output plus synthetic sentences, as a vlm_output."""
    rng = random.Random(5)
    results = json.loads(GOLDEN.read_text())["results"]
    results = results + [
        {"content": " ".join(tdata.synth_sentence(rng) for _ in range(4))}
        for _ in range(10)]
    path = tmp_path_factory.mktemp("corpus") / "vlm_output.json"
    path.write_text(json.dumps({"results": results}))
    return path


def _dataset(mod, captions):
    rng = random.Random(0)
    return mod.build_dataset(captions, rng, n_pre=12, n_instr=4, n_consol=4,
                             n_copy=4, n_synth_answers=6, qc_pairs=[])


@pytest.mark.parametrize("seq_len,max_new", [(512, 768), (256, 96)])
def test_tokenize_examples_equals_the_jax_scripts(scripts, corpus, seq_len,
                                                  max_new):
    captions = scripts["train_torch_instruct_lm"].load_captions(str(corpus))
    assert captions == scripts["train_instruct_lm"].load_captions(
        str(corpus))
    data = _dataset(tdata, captions)
    assert data == _dataset(jdata, captions)
    want = scripts["train_instruct_lm"].tokenize_examples(data, seq_len,
                                                          max_new)
    got = scripts["train_torch_instruct_lm"].tokenize_examples(
        data, seq_len, max_new)
    assert len(got) == len(want) > 0
    for (gt, gp), (wt, wp) in zip(got, want):
        assert gt.dtype == wt.dtype and gp.dtype == wp.dtype
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gp, wp)


@pytest.mark.parametrize("seq_len", [128, 333])
def test_pack_corpus_equals_the_jax_scripts(scripts, corpus, seq_len):
    captions = scripts["train_torch_instruct_lm"].load_captions(str(corpus))
    want = scripts["train_midscale"].pack_corpus(captions, seq_len,
                                                 random.Random(3))
    got = scripts["train_torch_midscale"].pack_corpus(captions, seq_len,
                                                      random.Random(3))
    assert got.dtype == want.dtype and got.shape[0] > 4
    np.testing.assert_array_equal(got, want)


def test_mid_config_and_flops_equal_the_jax_scripts(scripts):
    jm, tm = scripts["train_midscale"], scripts["train_torch_midscale"]
    jcfg, tcfg = jm.mid_config(1024), tm.mid_config(1024)
    assert (tcfg.width, tcfg.layers, tcfg.heads, tcfg.max_len) == (
        jcfg.width, jcfg.layers, jcfg.heads, jcfg.max_len)
    assert tcfg.num_params == jcfg.num_params
    assert tm.train_flops_per_token(tcfg, 1024) == jm.train_flops_per_token(
        jcfg, 1024)


def test_instruct_loss_and_one_update_match_the_jax_arithmetic(scripts):
    mod = scripts["train_torch_instruct_lm"]
    jcfg = jcap.CaptionerConfig(width=64, layers=2, heads=2, vision_dim=64,
                                num_vision_tokens=2, max_len=128)
    tcfg = tcap.CaptionerConfig(width=64, layers=2, heads=2, vision_dim=64,
                                num_vision_tokens=2, max_len=128)
    # float32 compute on both sides: the point is the loss mask, the clip,
    # the schedule and AdamW, not bfloat16 rounding
    import dataclasses
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jp = jcap.init_params(jcfg, seed=0)
    tp = tcap.trainable(captioner_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (4, 41)).astype(np.int32)
    toks[0, 30:] = jtok.PAD_ID
    toks[2, 12:] = jtok.PAD_ID
    plens = np.asarray([10, 25, 4, 39], np.int32)
    nv, lr, steps = jcfg.num_vision_tokens, 5e-4, 20
    warmup = min(200, max(1, steps // 10))

    def loss_fn(p, batch_toks, batch_plens):      # train_instruct_lm.py
        inputs = batch_toks[:, :-1]
        targets = batch_toks[:, 1:]
        vis = jnp.zeros((inputs.shape[0], nv, jcfg.vision_dim), jnp.float32)
        logits = jcap.forward(p, jcfg, vis, inputs, remat=True, flash=False)
        pos = jnp.arange(targets.shape[1])[None]
        mask = ((pos >= (batch_plens[:, None] - 1))
                & (targets != jtok.PAD_ID)).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
        end_value=lr * 0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    jo = tx.init(jp)
    opt = ttrain.AdamW(tp, ttrain.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1), lr * 0.05),
        weight_decay=0.01, max_norm=1.0)
    for step in range(3):     # step 0 has lr 0: three steps reach the peak
        jloss, grads = jax.value_and_grad(loss_fn)(jp, jnp.asarray(toks),
                                                   jnp.asarray(plens))
        updates, jo = tx.update(grads, jo, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        tloss = mod.instruct_loss(tp, tcfg, torch.from_numpy(toks),
                                  torch.from_numpy(plens), True, False)
        tloss.backward()
        opt.update()
        assert abs(tloss.item() - float(jloss)) < 1e-5, step
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    for key, leaf in tck.tree_leaves(tp):
        np.testing.assert_allclose(leaf.detach().numpy(), want[key],
                                   atol=1e-5, rtol=0, err_msg=key)


def _assert_jax_loads_bit_for_bit(template, path):
    """``vidgraph_tpu.models.checkpoint.load_params`` reads the port's npz
    and gives the port's own ``load_params`` leaves, bit for bit."""
    jtree = jck.load_params(template, str(path))
    ttree = tck.load_params(captioner_params_from_jax(
        jax.tree_util.tree_map(np.asarray, template)), str(path))
    jleaves = jax.tree_util.tree_leaves(jtree)
    tleaves = [leaf for _, leaf in tck.tree_leaves(ttree)]
    assert len(jleaves) == len(tleaves) > 0
    for a, b in zip(jleaves, tleaves):
        a = np.asarray(a)
        bf16, b = tck.to_numpy(b)
        if bf16:
            a = a.view(np.uint16)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_instruct_trainer_runs_resumes_and_serves(scripts, corpus,
                                                  tmp_path):
    mod = scripts["train_torch_instruct_lm"]
    out = tmp_path / "instruct_lm.npz"
    argv = ["--smoke", "--device", "cpu", "--corpus", str(corpus),
            "--seq-len", "768", "--max-new", "160", "--lr", "3e-3",
            "--out", str(out)]
    first = mod.main(argv + ["--steps", "8"])
    assert first["device"] == "cpu" and first["attention"] == "einsum"
    assert first["remat"] is True and len(first["losses"]) == 8
    assert all(np.isfinite(first["losses"]))
    assert first["held_last"] < first["held_first"], first
    assert first["eval"], "the teacher-match eval ran"
    meta = json.loads(out.with_suffix(".json").read_text())
    assert meta["seq_len"] == 768 and meta["max_new"] == 160
    cfg = jcap.CaptionerConfig(width=64, layers=2, heads=2, vision_dim=64,
                               num_vision_tokens=2, max_len=768 + 512)
    _assert_jax_loads_bit_for_bit(jcap.init_params(cfg), out)

    state = Path(str(out) + ".train_state.npz")
    assert state.exists()
    with np.load(state) as data:
        assert int(data["step"]) == 7
        assert "opt/exp_avg/blocks/0/qkv_w" in data.files
        assert int(data["opt/count"]) == 8
    second = mod.main(argv + ["--steps", "12", "--resume"])
    assert second["start_step"] == 8 and len(second["losses"]) == 4
    assert second["held_last"] <= first["held_last"]

    tcfg = tcap.CaptionerConfig(width=64, layers=2, heads=2, vision_dim=64,
                                num_vision_tokens=2, max_len=768 + 512)
    params = tck.load_params(tcap.init_params(tcfg), str(out))
    ids = ttok.encode("The scene shows", add_bos=True, add_eos=False)
    arr = np.full((1, 64), ttok.PAD_ID, np.int32)
    arr[0, :len(ids)] = ids
    toks = tcap.generate_from_tokens(params, tcfg, torch.from_numpy(arr),
                                     len(ids), max_new=16)
    assert toks.shape == (1, 16) and int(toks.min()) >= 0


def test_midscale_trainer_runs_and_round_trips(scripts, corpus, tmp_path):
    mod = scripts["train_torch_midscale"]
    out = tmp_path / "midscale_lm.npz"
    rec = mod.main(["--smoke", "--device", "cpu", "--corpus", str(corpus),
                    "--lr", "3e-3", "--out", str(out)])
    assert rec["device"] == "cpu" and rec["attention"] == "einsum"
    assert rec["remat"] is True and rec["bf16_roundtrip_exact"] is True
    assert rec["train_mfu"] is None, "no MFU is stated for a host run"
    assert len(rec["losses"]) == 6 and all(np.isfinite(rec["losses"]))
    assert rec["losses"][-1] < rec["losses"][0], rec["losses"]
    assert isinstance(rec["decode_sample"], str)
    assert json.loads(out.with_suffix(".json").read_text())["steps"] == 6
    cfg = jcap.CaptionerConfig(width=64, layers=2, heads=2, max_len=128 + 64)
    _assert_jax_loads_bit_for_bit(
        jcap.quantize_params(jcap.init_params(cfg), jnp.bfloat16), out)


def test_midscale_flash_flag_on_the_cpu_warns_and_keeps_remat(scripts,
                                                              corpus,
                                                              tmp_path):
    mod = scripts["train_torch_midscale"]
    with pytest.warns(RuntimeWarning, match="flash attention requested"):
        rec = mod.main(["--smoke", "--flash", "--device", "cpu", "--corpus",
                        str(corpus), "--out", str(tmp_path / "m.npz")])
    assert rec["attention"] == "einsum" and rec["remat"] is True


def test_captioner_trainer_runs_and_jax_loads_it(scripts, tmp_path):
    mod = scripts["train_torch_captioner"]
    out = tmp_path / "captioner_tiny.npz"
    rec = mod.main(["--steps", "8", "--batch", "4", "--dataset", "12",
                    "--lr", "1e-3", "--device", "cpu", "--out", str(out)])
    assert len(rec["losses"]) == 8 and all(np.isfinite(rec["losses"]))
    assert rec["losses"][-1] < rec["losses"][0], rec["losses"]
    vit_cfg = jvit.ViTConfig(image_size=64, patch_size=32, width=128,
                             layers=4, heads=4, embed_dim=64,
                             dtype=jnp.float32)
    cap_cfg = jcap.CaptionerConfig(width=128, layers=4, heads=4,
                                   vision_dim=64, num_vision_tokens=4,
                                   max_len=96 + 8, dtype=jnp.float32)
    _, vit_params = jvit.init_vision_tower(vit_cfg, 0)
    template = {"vit": vit_params, "cap": jcap.init_params(cap_cfg)}
    loaded = jck.load_params(template, str(out))
    with np.load(out) as data:
        for path, leaf in jax.tree_util.tree_leaves_with_path(loaded):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            np.testing.assert_array_equal(np.asarray(leaf), data[key])


@pytest.mark.parametrize("name", ["train_torch_instruct_lm",
                                  "train_torch_midscale",
                                  "train_torch_captioner"])
def test_the_default_device_is_cuda_and_its_absence_raises(scripts, name,
                                                           corpus, tmp_path,
                                                           monkeypatch):
    """``--smoke`` does not imply the CPU: without ``--device cpu`` a host
    with no card raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("VIDGRAPH_TORCH_DEVICE", "cpu")
    argv = ["--out", str(tmp_path / "x.npz")]
    if name != "train_torch_captioner":
        argv += ["--smoke", "--corpus", str(corpus)]
    with pytest.raises(RuntimeError, match="cuda"):
        scripts[name].main(argv)
