"""Checkpoints cross between the packages bit for bit (the JAX npz format
of ``vidgraph_tpu/models/checkpoint.py``): f32 and bf16 leaves, both
directions, on the CPU."""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import checkpoint as jck  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402


def _bits(x):
    """A leaf's raw bytes and dtype name, framework-free."""
    if isinstance(x, torch.Tensor):
        bf16, arr = tck.to_numpy(x)
        return ("bfloat16" if bf16 else arr.dtype.name), arr.tobytes()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return "bfloat16", arr.view(np.uint16).tobytes()
    return arr.dtype.name, arr.tobytes()


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _mixed_jax_params():
    """The tiny captioner with bf16 matrices and f32 vectors."""
    p = jcap.init_params(jcap.CaptionerConfig.tiny(), seed=2,
                         param_dtype=jnp.bfloat16)
    p["pos_emb"] = p["pos_emb"] + jnp.bfloat16(0.5)    # non-trivial bits
    return p


def _template(dtype_of):
    t = tcap.init_params(tcap.CaptionerConfig.tiny())
    return {k: ([{kk: vv.to(dtype_of(vv)) for kk, vv in b.items()}
                 for b in v] if k == "blocks" else v.to(dtype_of(v)))
            for k, v in t.items()}


def _keep_matrices_bf16(t):
    return torch.bfloat16 if t.dim() >= 2 else torch.float32


def test_jax_npz_loads_bit_exact(tmp_path):
    jp = _mixed_jax_params()
    path = jck.save_params(jp, str(tmp_path / "j.npz"))
    tp = tck.load_params(_template(_keep_matrices_bf16), path)
    flat_t = dict(tck.tree_leaves(tp))
    flat_j = _flat_jax(jp)
    assert set(flat_t) == set(flat_j)
    assert any(t.dtype == torch.bfloat16 for t in flat_t.values())
    for key, leaf in flat_j.items():
        assert _bits(flat_t[key]) == _bits(leaf), key


def test_port_npz_loads_bit_exact_in_jax(tmp_path):
    tp = tcap.init_params(tcap.CaptionerConfig.tiny(),
                          5,
                          param_dtype=torch.bfloat16)
    tp["ln_f_bias"] = torch.linspace(-1, 1, 32)
    path = tck.save_params(tp, str(tmp_path / "sub" / "t.npz"))
    assert not list((tmp_path / "sub").glob("*.tmp*"))     # replaced
    template = jcap.init_params(jcap.CaptionerConfig.tiny(), seed=0,
                                param_dtype=jnp.bfloat16)
    jp = jck.load_params(template, path)
    flat_t = dict(tck.tree_leaves(tp))
    for key, leaf in _flat_jax(jp).items():
        assert _bits(leaf) == _bits(flat_t[key]), key


def test_port_roundtrip_and_dtype_cast(tmp_path):
    tp = tcap.init_params(tcap.CaptionerConfig.tiny(),
                          param_dtype=torch.bfloat16)
    path = tck.save_params(tp, str(tmp_path / "t.npz"))
    back = tck.load_params(tp, path)
    for (k, a), (_, b) in zip(tck.tree_leaves(tp), tck.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    as_f32 = tck.load_params(_template(lambda t: torch.float32), path)
    for (k, a), (_, b) in zip(tck.tree_leaves(tp), tck.tree_leaves(as_f32)):
        assert b.dtype == torch.float32 and torch.equal(a.float(), b), k


def test_missing_key_and_shape_mismatch_raise(tmp_path):
    tp = tcap.init_params(tcap.CaptionerConfig.tiny())
    path = tck.save_params({"tok_emb": tp["tok_emb"]}, str(tmp_path / "a.npz"))
    with pytest.raises(KeyError, match="pos_emb"):
        tck.load_params({"tok_emb": tp["tok_emb"], "pos_emb": tp["pos_emb"]},
                        path)
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_params({"tok_emb": tp["tok_emb"][:3]}, path)
