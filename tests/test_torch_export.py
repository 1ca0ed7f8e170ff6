"""The port's ``export`` mode on the CPU: the serving kernels as
``torch.library`` ops (``kernels/library.py``), the ``torch.export``
artifact (``export/aot.py``) against the port's eager uint8 step and the
JAX package's ``jax.export`` artifact, and ``python -m ircolor_tpu_torch
export`` (mirrors ``tests/test_eval.py:222-360`` and
``tests/test_quant.py:210``)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ircolor_tpu.export import aot as jaot
from ircolor_tpu.models.wrapper import generator_from_config as jax_generator

from ircolor_tpu_torch.cli import main
from ircolor_tpu_torch.compat import state_dict_from_flax
from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.eval.runner import make_infer_fn
from ircolor_tpu_torch.export import aot
from ircolor_tpu_torch.kernels import library, resblock
from ircolor_tpu_torch.models.wrapper import IRColorizationModel
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eager_u8(module, ir):
    """The port's eager uint8 step (``make_infer_fn``) on float IR."""
    pred, _ = make_infer_fn(module)(ir, torch.zeros((*ir.shape[:3], 3)))
    return pred


def _ir(b, h, w, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).uniform(-1, 1, (b, h, w, 1))
                            .astype(np.float32))


def _program(blob):
    return aot.load_program(io.BytesIO(blob))


# ---------------------------------------------------------------- the ops ----

def _opcheck_cases():
    g = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    def q8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    x = rand(2, 8, 8, 16, dtype=torch.bfloat16)
    k = rand(3, 3, 16, 16, scale=0.1, dtype=torch.bfloat16)
    mean, inv = rand(2, 16), rand(2, 16).abs() + 0.5
    sc = rand(2, 16).abs() * 1e-3
    qs = rand(2).abs() + 1.0
    return {
        "reflect_fused": ("conv3x3_reflect_fused", (x, k, None, None)),
        "reflect_fused_norm": ("conv3x3_reflect_fused", (x, k, mean, inv)),
        "reflect_fused_q": ("conv3x3_reflect_fused_q", (x, q8(3, 3, 16, 16), sc, qs, None, None)),
        "reflect_fused_q_norm": ("conv3x3_reflect_fused_q",
                                 (x, q8(3, 3, 16, 16), sc, None, mean, inv)),
        "blur": ("norm_relu_blur_down", (x, mean, inv)),
        "head": ("conv7x7_head", (x, mean, inv, rand(7, 7, 16, 3, scale=0.05), False)),
        "head_quant": ("conv7x7_head", (x, mean, inv, rand(7, 7, 16, 3, scale=0.05), True)),
        "int8_s1": ("conv3x3_int8", (q8(2, 8, 8, 16), q8(3, 3, 16, 32), sc.repeat(1, 2), "reflect",
                                     1, rand(32), None, torch.bfloat16)),
        "int8_s1_addend": ("conv3x3_int8", (q8(2, 8, 8, 16), q8(3, 3, 16, 32), sc.repeat(1, 2),
                                            "zero", 1, None, rand(2, 8, 8, 32), torch.float32)),
        "int8_s2": ("conv3x3_int8", (q8(2, 8, 8, 16), q8(3, 3, 16, 32), sc.repeat(1, 2), "zero", 2,
                                     rand(32), None, torch.bfloat16)),
        "run_in": ("run_in", (x, False)),
        "run_in_relu": ("run_in", (rand(2, 8, 8, 16), True)),
        "run_in_res": ("run_in_res", (x, rand(2, 8, 8, 16, dtype=torch.bfloat16))),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_ops_pass_opcheck(case):
    """Each op's schema, fake kernel (shapes, dtypes, strides), and its CPU
    kernel under the dispatcher's checks; the CPU kernel is the plain
    version of the wrapper."""
    name, args = _opcheck_cases()[case]
    torch.library.opcheck(library.op(name).default, args)
    got = library.op(name)(*args)
    want = library.PLAIN[library.op(name).default](*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted({name for name, _ in _opcheck_cases().values()}))
def test_ops_run_on_cuda_and_cpu_only(name):
    """A kernel for CUDA (the launch) and the CPU (the plain version), a
    fake one (Meta), and no default: any other device raises."""
    qualified = f"ircolor::{name}"
    has = {key: torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key)
           for key in ("CUDA", "CPU", "Meta", "CompositeExplicitAutograd",
                       "CompositeImplicitAutograd", "XPU")}
    assert has == {"CUDA": True, "CPU": True, "Meta": True, "CompositeExplicitAutograd": False,
                   "CompositeImplicitAutograd": False, "XPU": False}


def test_eager_wrappers_dispatch_no_op_outside_a_trace():
    """Outside an export trace the gate-open int8 and float forwards send
    no ``ircolor::`` op through the dispatcher (every op it dispatches is
    recorded), so eager pays no op dispatch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = set()

    class Namespaces(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(func.namespace)
            return func(*args, **(kwargs or {}))

    for quant in (True, False):
        m = _gated(quant, quant_head=quant, quant_fixed_u2=quant)
        with torch.inference_mode(), Namespaces():
            assert _eager_u8(m.module, _ir(2, 64, 64)).shape == (2, 64, 64, 3)
    assert "aten" in seen and "ircolor" not in seen


# ------------------------------------------------------------ the artifact ----

def _gated(quant, **kw):
    """bf16 at 64×64 b2 (the small-batch band), ngf 32 (the block width
    128): the fused blocks, the down2 tail and the head engage; with
    ``quant_head`` and ``quant_fixed_u2`` also the int8 head and the int8
    up2 conv."""
    cfg = Config(img_size=64, ngf=32, n_blocks=1, compute_dtype="bf16", quant_int8=quant, **kw)
    return IRColorizationModel(cfg, "cpu")


def test_f32_roundtrip_matches_eager_and_jax(tmp_path):
    """f32, ngf 8, 32×32 b2: JAX's weights carried across. The port's
    portable artifact, loaded here and in a process where
    ``ircolor_tpu_torch`` cannot be imported, is its eager uint8 step bit
    for bit; against JAX's ``jax.export`` artifact it is within one uint8
    level on ≥ 99% of the values identical, where the f32 generators agree
    within 2e-5."""
    cfg = Config(img_size=32, n_blocks=1, ngf=8)
    jm = jax_generator(cfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 32, 32, 1)))["params"])
    model = IRColorizationModel(cfg, "cpu")
    model.module.load_state_dict(state_dict_from_flax(params), strict=False)
    ir = _ir(2, 32, 32)

    path = tmp_path / "netG_serving.pt2"
    aot.save_exported(str(path), aot.export_inference(model.module, 32, 32, batch_size=2))
    got = aot.load_exported(str(path))(ir)
    with torch.inference_mode():
        assert torch.equal(got, _eager_u8(model.module, ir))
        fake = model.module(ir).numpy()
    want_fake = np.asarray(jm.apply({"params": params}, jnp.asarray(ir.numpy())))
    np.testing.assert_allclose(fake, want_fake, atol=2e-5)

    blob = jaot.export_inference(jm, params, 32, 32, batch_size=2, platforms=("cpu",))
    want = np.asarray(jax.export.deserialize(blob).call(jnp.asarray(ir.numpy())))
    d = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert got.dtype == torch.uint8 and d.max() <= 1 and (d == 0).mean() >= 0.99

    np.save(tmp_path / "ir.npy", ir.numpy())
    code = (
        "import sys; sys.modules['ircolor_tpu_torch'] = None\n"
        "import numpy as np, torch\n"
        f"ep = torch.export.load({str(path)!r})\n"
        f"out = ep.module()(torch.from_numpy(np.load({str(tmp_path / 'ir.npy')!r})))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert np.array_equal(np.load(tmp_path / "out.npy"), got.numpy())


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "float"])
def test_keep_pallas_holds_the_kernels(quant):
    """``keep_pallas`` with the gates open: the graph calls the serving
    kernels' ops (int8: the block conv, the down2 tail, the int8 up2 conv,
    the int8 head; float: the block conv, the down2 tail, the head; the
    down1 tail's 64 channels are off its gate), which run their plain
    versions on the CPU: bit-identical to the eager module."""
    kw = {"quant_head": True, "quant_fixed_u2": True} if quant else {}
    m = _gated(quant, **kw)
    blob = aot.export_inference(m.module, 64, 64, batch_size=2, keep_pallas=True)
    calls = aot.kernel_calls(_program(blob))
    block = "ircolor::conv3x3_reflect_fused" + ("_q" if quant else "")
    want = {block: 2, "ircolor::norm_relu_blur_down": 1, "ircolor::conv7x7_head": 1}
    if quant:
        want["ircolor::conv3x3_int8"] = 2  # the up2 conv's two legs
    assert dict(calls) == want
    assert aot.artifact_has_kernels(blob)
    ir = _ir(2, 64, 64, seed=1)
    with torch.inference_mode():
        assert torch.equal(_program(blob).module()(ir), _eager_u8(m.module, ir))


def test_keep_pallas_off_the_gates_warns(caplog):
    m = IRColorizationModel(Config(img_size=32, n_blocks=1, ngf=8), "cpu")
    blob = aot.export_inference(m.module, 32, 32, batch_size=1, keep_pallas=True)
    assert not aot.artifact_has_kernels(blob)
    assert "no fused kernel engaged" in caplog.text


def test_portable_artifact_is_aten_only(monkeypatch):
    """The default artifact of a gate-open int8 module (bf16 32×32 b2,
    ngf 32, ``use_pallas``: the fused blocks and the down2 tail would
    engage): no ``ircolor::`` op (the int8 conv replaced by its plain
    version), no fused kernel traced (they raise if reached), and
    bit-identical to the eager route with the four gates off."""
    m = IRColorizationModel(Config(img_size=32, ngf=32, n_blocks=1, compute_dtype="bf16",
                                   quant_int8=True, use_pallas=True), "cpu")

    def boom(*a, **k):
        raise AssertionError("a fused kernel was traced into the portable artifact")

    with monkeypatch.context() as mp:
        for name in ("resnet_block_pallas_q", "resnet_block_pallas", "norm_relu_blur_down",
                     "outc_head", "outc_head_q"):
            mp.setattr(f"ircolor_tpu_torch.models.generator.{name}", boom)
        mp.setattr("ircolor_tpu_torch.kernels.instance_norm.run_in", boom)
        blob = aot.export_inference(m.module, 32, 32, batch_size=2)
    prog = _program(blob)
    assert not aot.kernel_calls(prog)
    ir = _ir(2, 32, 32, seed=2)
    with torch.inference_mode():
        assert torch.equal(prog.module()(ir), _eager_u8(aot.without_kernels(m.module), ir))


def test_batchnorm_export_carries_running_stats():
    """norm="batch": the running statistics ride in the artifact, and the
    artifact is the eager step bit for bit."""
    m = IRColorizationModel(Config(img_size=32, n_blocks=1, ngf=8, norm="batch"), "cpu")
    gen = torch.Generator().manual_seed(0)
    for bn in m.module.modules():
        if hasattr(bn, "running_var"):
            bn.running_mean.copy_(torch.randn(bn.running_mean.shape, generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=gen) + 0.5)
    blob = aot.export_inference(m.module, 32, 32, batch_size=1)
    prog = _program(blob)
    assert any("running_var" in name for name in prog.state_dict)
    ir = _ir(1, 32, 32, seed=3)
    with torch.inference_mode():
        assert torch.equal(prog.module()(ir), _eager_u8(m.module, ir))


@pytest.mark.parametrize("pad,stride", [("zero", 1), ("reflect", 1), ("valid", 1), ("zero", 2)])
def test_int8_plain_is_exact_in_chunks(monkeypatch, pad, stride):
    """The int8 conv's plain version (the portable artifact's int8 conv)
    takes its images in chunks under a byte budget: bit-identical to one
    chunk of all."""
    from ircolor_tpu_torch.kernels import conv_int8

    g = torch.Generator().manual_seed(7)
    q = torch.randint(-127, 128, (5, 9, 11, 16), generator=g).float()
    kq = torch.randint(-127, 128, (3, 3, 16, 24), generator=g).float()
    whole = conv_int8.int_conv_exact(q, kq, pad, stride)
    monkeypatch.setattr(conv_int8, "_EXACT_CHUNK_BYTES", 2 * 11 * 13 * 16 * 8)
    assert torch.equal(conv_int8.int_conv_exact(q, kq, pad, stride), whole)


def test_artifact_size_does_not_grow_with_the_batch():
    """The stored example input is a broadcast zero, not a batch."""
    m = IRColorizationModel(Config(img_size=32, n_blocks=1, ngf=8), "cpu")
    sizes = {len(aot.export_inference(m.module, 32, 32, batch_size=b)) for b in (1, 8)}
    assert len(sizes) == 1


# ------------------------------------------------------------------ the CLI ----

def test_cli_export_writes_the_eager_step(tmp_path):
    out = tmp_path / "serve" / "g.pt2"
    args = ["export", "--device", "cpu", "--img-size", "32", "--ngf", "8", "--n-blocks", "1",
            "--test-batch-size", "2", "--export-out", str(out)]
    assert main(args) == 0
    cfg = Config(img_size=32, ngf=8, n_blocks=1, test_batch_size=2)
    ir = _ir(2, 32, 32, seed=4)
    with torch.inference_mode():
        want = _eager_u8(IRColorizationModel(cfg, "cpu").module, ir)
    assert torch.equal(aot.load_exported(str(out))(ir), want)


@pytest.mark.parametrize("extra,match", [
    (["--device", "cpu", "--export-keep-pallas"], "cuda"),
    (["--export-platforms", "cuda,cpu"], "one device"),
], ids=["keep_pallas_off_the_card", "two_platforms"])
def test_cli_export_refuses(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        main(["export", "--img-size", "32", "--ngf", "8", "--n-blocks", "1",
              "--export-out", str(tmp_path / "g.pt2"), *extra])
    assert not (tmp_path / "g.pt2").exists()


def test_export_resblock_wrapper_reaches_its_op_only_in_a_trace():
    """In a trace the reflect form is the op; its halo forms stay off it."""
    x = torch.randn(1, 4, 8, 64)
    k = torch.randn(3, 3, 64, 128) * 0.05

    class Conv(torch.nn.Module):
        def forward(self, x):
            return resblock.conv3x3_reflect_fused(x, k)[0]

    prog = torch.export.export(Conv(), (x,), strict=False)
    assert dict(aot.kernel_calls(prog)) == {"ircolor::conv3x3_reflect_fused": 1}
    assert torch.equal(prog.module()(x), resblock.conv3x3_reflect_fused_plain(x, k)[0])
