"""The plain reference against the port's CPU path at the tiny presets:
the same seeded weights bit for bit, and the same function in float32."""
import pytest
import torch

from perfbench.reference import captioner as ref_cap
from perfbench.reference import optim
from perfbench.reference import preprocess as ref_pre
from perfbench.reference import vit as ref_vit

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
CAP = dict(width=32, layers=2, heads=2, vocab=259, vision_dim=32,
           num_vision_tokens=2, max_len=64)
VIT = dict(image_size=64, patch_size=32, width=64, layers=2, heads=2,
           embed_dim=32, mlp_ratio=4)


@pytest.fixture
def port_cap():
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    cfg = CaptionerConfig(**CAP, dtype=torch.float32)
    return cfg, init_params(cfg, SEED, device=CPU)


@pytest.fixture
def port_tower():
    from vidgraph_tpu_torch.models.vit import ViTConfig, init_vision_tower
    cfg = ViTConfig(**{k: v for k, v in VIT.items()}, dtype=torch.float32)
    return init_vision_tower(cfg, SEED, device=CPU)


def test_captioner_weights_are_the_ports(port_cap):
    _, port = port_cap
    ref = ref_cap.init_params(CAP, SEED, "float32", CPU)
    port_leaves = {k: v for k, v in port.items() if k != "blocks"}
    for i, bp in enumerate(port["blocks"]):
        port_leaves.update({f"blocks/{i}/{k}": v for k, v in bp.items()})
    assert set(port_leaves) == set(ref_cap.leaves(ref))
    for k, v in ref_cap.leaves(ref).items():
        assert torch.equal(v, port_leaves[k]), k


def test_tower_weights_are_the_ports(port_tower):
    ref = ref_vit.init_tower(VIT, SEED, CPU)
    port = dict(port_tower.named_parameters())
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert torch.equal(v, port[k].detach()), k


def test_captioner_forward(port_cap):
    from vidgraph_tpu_torch.models.captioner import forward
    cfg, port = port_cap
    ref = ref_cap.init_params(CAP, SEED, "float32", CPU)
    g = torch.Generator().manual_seed(1)
    vis = torch.randn((3, 2, 32), generator=g)
    toks = torch.randint(0, 259, (3, 11), generator=g)
    want = ref_cap.forward(ref, CAP, vis, toks)
    got = forward(port, cfg, vis, toks)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_tower(port_tower):
    ref = ref_vit.init_tower(VIT, SEED, CPU)
    imgs = torch.randn((3, 64, 64, 3),
                       generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = port_tower(imgs)
    assert torch.allclose(got, ref_vit.tower(ref, VIT, imgs), atol=1e-5)


def test_preprocessing():
    from vidgraph_tpu_torch.ops.preprocess import preprocess_ref
    frames = torch.randint(0, 256, (2, 45, 80, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    got = preprocess_ref(frames, 32, fast=False)
    assert torch.allclose(got, ref_pre.preprocess(frames, 32), atol=1e-4)


def test_training_steps_follow_the_ports(train_cell):
    """Three steps of the port's composed step (float32 tiny) and of the
    reference from the same seed, past the warmup: losses, first
    gradients and changes."""
    from perfbench.harness import generate, train
    train_cell.config["captioner"]["dtype"] = "float32"
    trainer = train.Trainer(train_cell.config, train_cell.traffic, SEED, CPU)
    batches = generate.byte_batches(train_cell.traffic, SEED, CPU)
    first = train.setup_steps(trainer, batches, 3)
    ref = train.reference_steps(train_cell, SEED, first["batches"], CPU)
    assert first["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    for k, v in ref["grad_norms"].items():
        assert first["grad_norms"][k] == pytest.approx(v, rel=1e-4,
                                                       abs=1e-9), k
    assert train.gaps(first, ref)["delta_gap"] < 1e-3


def test_optax_schedule():
    assert optim.lr_at(0, 5e-4, 200, 6000, 2.5e-5) == 0.0
    assert optim.lr_at(100, 5e-4, 200, 6000, 2.5e-5) == pytest.approx(2.5e-4)
    assert optim.lr_at(200, 5e-4, 200, 6000, 2.5e-5) == pytest.approx(5e-4)
    assert optim.lr_at(9000, 5e-4, 200, 6000, 2.5e-5) == pytest.approx(2.5e-5)
