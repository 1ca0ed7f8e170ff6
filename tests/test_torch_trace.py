"""The spans of the serving and training steps (``utils.timing.span``) on
the CPU, at a tiny size (32², ngf 8, one block, b2).

Under ``torch.profiler`` each step records its phases and the generator's
stages as ``ircolor.*`` ranges, nested as the table below says, with the
step's ordinal on its own span (``serve.step#n``, ``train.step#n``). The
kernel spans (``kernel.*``, around a card launch) and ``train.allreduce``
(around a data-parallel gradient reduction) do not open here. With no
profiler recording a span makes no range (the range's constructor patched
to raise changes nothing), and the outputs are bit-identical with and
without a profiler."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ircolor_tpu_torch.config import Config
from ircolor_tpu_torch.eval.runner import make_infer_fn
from ircolor_tpu_torch.losses.vgg import VGG16Features
from ircolor_tpu_torch.models.wrapper import IRColorizationModel
from ircolor_tpu_torch.train.state import create_train_state
from ircolor_tpu_torch.train.step import make_train_step
from ircolor_tpu_torch.utils.timing import SPAN_PREFIX
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

_G = ("g.inc", "g.down1", "g.down2", "g.blocks", "g.up1", "g.up2", "g.head")
# Each span with the span it opens in (None: the outermost).
_PARENT = {
    "serve": {"serve.step": None,
              **{k: "serve.step" for k in ("serve.decode", "serve.generator", "serve.uint8",
                                           "serve.metrics")},
              **{k: "serve.generator" for k in _G}},
    "train": {"train.step": None,
              **{k: "train.step" for k in ("train.decode", "train.g_forward", "train.d_forward",
                                           "train.d_backward", "train.d_adam", "train.g_gan",
                                           "train.losses", "train.g_backward", "train.g_adam")},
              **{f"loss.{k}": "train.losses" for k in ("l1", "vgg", "tv", "ssim")},
              **{k: "train.g_forward" for k in _G}},
}


def _batch():
    gen = torch.Generator().manual_seed(3)
    return (torch.randint(0, 65536, (2, 32, 32, 1), generator=gen).to(torch.uint16),
            torch.randint(0, 256, (2, 32, 32, 3), generator=gen).to(torch.uint8))


class _Steps:
    """Fresh seeded weights; ``once()`` runs one serving or training step
    on the fixed batch and returns every output and, for training, every
    parameter after it."""

    def __init__(self, kind: str, vgg: VGG16Features):
        self.kind = kind
        if kind == "serve":
            cfg = Config(img_size=32, ngf=8, n_blocks=1, mode="test", test_batch_size=2)
            self.fn = make_infer_fn(IRColorizationModel(cfg, "cpu").module)
        else:
            cfg = Config(img_size=32, ngf=8, n_blocks=1, batch_size=2, mode="train")
            self.state = create_train_state(cfg, steps_per_epoch=10, device="cpu")
            self.fn = make_train_step(cfg, vgg)

    def once(self) -> list[torch.Tensor]:
        ir, gt = _batch()
        if self.kind == "serve":
            pred, m = self.fn(ir, gt)
            return [pred, *m.values()]
        self.state, m = self.fn(self.state, {"ir": ir, "rgb": gt})
        return [*m.values(), *self.state.g.parameters(), *self.state.d.parameters()]


def _spans(prof) -> list[tuple[int, int, int, str]]:
    return sorted((e.start_thread_id(), e.start_ns(), e.end_ns(), e.name()[len(SPAN_PREFIX):])
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(SPAN_PREFIX))


def _parent(span, spans):
    tid, a, b, _ = span
    outer = [s for s in spans if s is not span and s[0] == tid and s[1] <= a and b <= s[2]]
    return max(outer, key=lambda s: s[1])[3].partition("#")[0] if outer else None


@pytest.fixture(scope="module")
def vgg():
    return VGG16Features().eval()


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_step_records_its_spans_nested_with_ordinals(kind, vgg):
    steps = _Steps(kind, vgg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.once()
        steps.once()
    spans = _spans(prof)
    assert {s[3].partition("#")[0] for s in spans} == set(_PARENT[kind])
    for s in spans:
        assert _parent(s, spans) == _PARENT[kind][s[3].partition("#")[0]], s
    ordinals = [int(s[3].partition("#")[2]) for s in spans if s[3].startswith(f"{kind}.step#")]
    assert len(ordinals) == 2 and ordinals[1] == ordinals[0] + 1
    assert all("#" not in s[3] for s in spans if not s[3].startswith(f"{kind}.step#"))


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_spans_off_make_no_range_and_outputs_match_a_profiled_step(kind, vgg, monkeypatch):
    traced = _Steps(kind, vgg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        want = traced.once()
    assert _spans(prof)

    def no_range(*args, **kwargs):
        raise AssertionError("a range was made with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    got = _Steps(kind, vgg).once()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
