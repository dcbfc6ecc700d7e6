"""The counts against numbers worked by hand at one small shape."""
from perfbench.counts import (attention_bwd, attention_fwd, decode_step,
                              model_flops)

# b 2, h 3, t 4, hd 8, nv 2: rows 0 and 1 see keys 0-1, row 2 keys 0-2 and
# row 3 keys 0-3, so 2 * 2 + 3 + 4 = 11 visible pairs a head
B, H, T, HD, NV = 2, 3, 4, 8, 2
DEC = {"width": 4, "layers": 2, "heads": 2, "vocab": 10, "vision_dim": 3,
       "num_vision_tokens": 2, "dtype": "bfloat16", "param_dtype": "bfloat16"}
VIT = {"image_size": 64, "patch_size": 32, "width": 4, "layers": 1,
       "heads": 1, "embed_dim": 2, "mlp_ratio": 4}


def test_visible_pairs():
    assert attention_fwd.visible_pairs(T, NV) == 11
    assert attention_fwd.visible_pairs(4, 0) == 10     # plain causal: half
    assert attention_fwd.visible_pairs(4, 4) == 16     # all mutually visible


def test_attention_forward():
    assert attention_fwd.ops(B, H, T, HD, NV) == 4 * 8 * 11 * 2 * 3 == 2112
    # q, k, v, o: 4 x 2 x 4 x 3 x 8 x 2 bytes; lse 4 x 2 x 3 x 4 bytes
    assert attention_fwd.bytes_moved(B, H, T, HD) == 1536 + 96
    assert attention_fwd.bytes_moved(B, H, T, HD, lse=False) == 1536


def test_attention_backward():
    assert attention_bwd.ops(B, H, T, HD, NV) == 8 * 8 * 11 * 6 == 4224
    # q, k, v, o, dO in; dq, dk, dv out; lse in
    assert attention_bwd.bytes_moved(B, H, T, HD) == 3072 + 96


def test_decode_bytes():
    # two layers of 12 d^2 and a 4 x 10 head, 2 bytes each
    assert decode_step.weight_bytes(DEC) == (2 * 12 * 16 + 40) * 2 == 848
    # K and V: 2 layers x 2 x width 4 x batch 3 x 2 bytes = 96 a slot
    assert decode_step.step_bytes(DEC, 3, 5) == 848 + 96 * 5 + 96
    assert decode_step.decode_bytes(DEC, 3, 2, 2) == \
        (848 + 96 * 3 + 96) + (848 + 96 * 4 + 96) == 2560


def test_model_flops():
    # 4 patches + cls; patch embed 2 x 3072 x 4 x 4; a block 2 x 192 x 5
    # and 4 x 4 x 25 of attention; the projection of cls 2 x 4 x 2
    assert model_flops.vit_forward(VIT, 2) == 2 * (98304 + 1920 + 400 + 16)
    # t = 2 slots + 2 tokens: blocks 2 x 2 x 192 x 4, head 2 x 4 x 10 x 2,
    # vision projection 2 x 3 x 4 x 2, attention 2 x 4 x 2 x 11 x 2
    fwd = 3072 + 160 + 48 + 2 * 176
    assert model_flops.decoder_forward(DEC, 1, 2, 2) == fwd
    assert model_flops.decoder_train(DEC, 1, 2) == 3 * fwd
    # a step: 2 x (2 x 2 x 192 + 2 x 4 x 10 + 2 x 4 x 4 x 3) for batch 2
    assert model_flops.decode_step(DEC, 2, 3) == 2 * (768 + 80 + 96)
