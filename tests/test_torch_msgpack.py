"""The JAX package's ``.msgpack`` generator exports in the port: the codec
(``compat/msgpack.py``) against ``flax.serialization`` both ways and
without the ``msgpack`` package, ``compat.flax_from_state_dict``,
``train.checkpoint.save_netg_export`` / ``load_netg_export``, and the
files as ``test_G_weights`` and ``init_G_weights``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from ircolor_tpu.models.wrapper import generator_from_config as jax_generator
from ircolor_tpu.train import checkpoint as jckpt

from ircolor_tpu_torch.compat import flax_from_state_dict, msgpack as pmsgpack, state_dict_from_flax
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.models.wrapper import IRColorizationModel
from ircolor_tpu_torch.train import checkpoint as tckpt
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    """Every type flax's format holds: maps, str (fix, 8-bit), bin, ints of
    every width and sign, float, bool, nil, arrays, ndarrays (float32,
    int64, uint8, empty, one past the 16-bit ext length) and a numpy
    scalar."""
    rng = np.random.RandomState(0)
    return {
        "conv": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
                 "bias": rng.randn(5).astype(np.float32)},
        "misc": {"ints": [0, 127, 128, 255, 256, 65536, 2**40, -1, -32, -33, -200, -2**20, -2**40],
                 "f": 1.5, "t": True, "no": False, "n": None, "s": "short",
                 "s40": "x" * 40, "bin": b"\x00\xff" * 150, "scalar": np.float32(3.5),
                 "i64": np.arange(20, dtype=np.int64), "u8": np.arange(7, dtype=np.uint8),
                 "empty": np.zeros((0, 3), np.float32),
                 "big": rng.randn(17000).astype(np.float32)},
        "many": {f"k{i:02d}": i for i in range(20)},
    }


def _assert_same_tree(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves(b)):
        if isinstance(x, (np.ndarray, np.generic)):
            assert (x.dtype, x.shape) == (y.dtype, y.shape), path
            assert x.tobytes() == y.tobytes(), path
        else:
            assert type(x) is type(y) and x == y, path


@pytest.mark.parametrize("direction", ["port_to_flax", "flax_to_port"])
def test_codec_matches_flax(direction):
    """The port's bytes are flax's bytes; each side restores the other's to
    the same tree, leaf for leaf and bit for bit."""
    tree = _tree()
    mine, theirs = pmsgpack.msgpack_serialize(tree), serialization.msgpack_serialize(tree)
    assert mine == theirs
    if direction == "port_to_flax":
        _assert_same_tree(serialization.msgpack_restore(mine), tree)
    else:
        _assert_same_tree(pmsgpack.msgpack_restore(theirs), tree)


def test_codec_refuses_chunked_leaves():
    blob = serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        pmsgpack.msgpack_restore(blob)


def test_codec_runs_without_the_msgpack_package(tmp_path):
    """The card's machine has no ``msgpack``, flax or jax: the codec reads a
    flax file in a process where ``import msgpack`` fails."""
    path = tmp_path / "netG.msgpack"
    path.write_bytes(serialization.msgpack_serialize(_tree()))
    code = (
        "import sys; sys.modules['msgpack'] = None; sys.path.insert(0, '.')\n"
        "from ircolor_tpu_torch.compat.msgpack import msgpack_restore, msgpack_serialize\n"
        f"data = open({str(path)!r}, 'rb').read()\n"
        "assert msgpack_serialize(msgpack_restore(data)) == data\n"
        "bad = [m for m in ('msgpack', 'flax', 'jax') if sys.modules.get(m) is not None]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_VARIANTS = {
    "default": {},
    "no_antialias": {"no_antialias": True, "no_antialias_up": True},
    "batch": {"norm": "batch"},
}


def _jax_params(cfg):
    module = jax_generator(cfg)
    params = jax.jit(module.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)))["params"]
    return module, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("variant", ["default", "no_antialias"])
def test_jax_export_loads_into_the_port(tmp_path, variant):
    """A JAX ``save_netg_export`` file as ``test_G_weights``: the same
    weights as the params carried across directly, and the port's f32
    forward within 2e-5 of JAX's (the f32 parity bound)."""
    cfg = Config(img_size=32, n_blocks=1, ngf=8, **_VARIANTS[variant])
    module, params = _jax_params(cfg)
    stem = str(tmp_path / "netG_best")
    jckpt.save_netg_export(params, stem, also_pth=False)
    model = IRColorizationModel(cfg, "cpu")
    model.load_weights(stem + ".msgpack")
    want_sd = state_dict_from_flax(params)
    got_sd = model.module.state_dict()
    assert all(torch.equal(got_sd[k], v) for k, v in want_sd.items())
    x = np.random.RandomState(2).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_port_export_restores_in_jax_bit_for_bit(tmp_path, variant):
    """JAX params → the port's generator → ``save_netg_export`` → JAX's
    ``load_netg_export``: the same tree, every float32 leaf bit-identical
    to the params it came from; the ``.pth`` beside it."""
    cfg = Config(img_size=32, n_blocks=2, ngf=8, **_VARIANTS[variant])
    _, params = _jax_params(cfg)
    g = IRColorizationModel(cfg, "cpu").module
    g.load_state_dict(state_dict_from_flax(params), strict=False)
    written = tckpt.save_netg_export(g, str(tmp_path / "netG_epoch_001"))
    assert [os.path.basename(p) for p in written] == ["netG_epoch_001.msgpack",
                                                      "netG_epoch_001.pth"]
    _assert_same_tree(jckpt.load_netg_export(written[0]), params)
    _assert_same_tree(flax_from_state_dict(g.state_dict()), params)


def test_msgpack_init_weights_train(kaist_tree, tmp_path):
    """A ``.msgpack`` ``init_G_weights`` starts ``train_kaist`` (lr 0, so G
    ends where the file put it), and each save writes both files."""
    from ircolor_tpu_torch.train.loop import train_kaist

    root, _ = kaist_tree
    cfg = Config(img_size=32, n_blocks=1, ngf=8, batch_size=2, epochs=1, save_every=1,
                 lr_G=0.0, lambda_perc=0.0, num_workers=1, train_roots=(str(root / "set00"),),
                 save_dir=str(tmp_path / "ckpt"))
    _, params = _jax_params(cfg)
    jckpt.save_netg_export(params, str(tmp_path / "init"), also_pth=False)
    summary = train_kaist(cfg.replace(init_G_weights=str(tmp_path / "init.msgpack")),
                          device="cpu", max_steps_per_epoch=1)
    _assert_same_tree(flax_from_state_dict(summary["state"].g.state_dict()), params)
    for name in ("netG_epoch_001", "netG_best"):
        for ext in (".msgpack", ".pth"):
            assert os.path.isfile(tmp_path / "ckpt" / (name + ext))
    _assert_same_tree(tckpt.load_netg_export(str(tmp_path / "ckpt" / "netG_best.msgpack")),
                      params)
