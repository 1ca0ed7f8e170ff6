"""The one general generator of the benchmark's traffic: a mix is a data file
(``traffic/<name>.json``) whose ``kind`` picks one of the loops below and
whose numbers size it. Each loop drives the program's own entry points:

  serve   ``eval/runner.py:make_infer_fn`` on ``models/wrapper.py:
          IRColorizationModel``, a closed loop as ``run_test`` dispatches
          it: each batch uploaded from pinned host memory, its step
          enqueued, its uint8 prediction and metrics copied back without
          waiting, and only then the previous batch's results awaited (one
          batch in flight). The frames cycle through a pool of distinct
          seeded batches.
  train   ``train/step.py:make_train_step`` over ``train/state.py:
          create_train_state``: set-up runs the first ``checked_steps``
          steps through the same call and feed (the reference follows them),
          then the window goes on from there, a seeded batch uploaded each
          step.

Spans (``trace.Spans``) wrap the calls into each layer: ``upload`` (the H2D
copies), ``step`` (the program's call up to its return), ``readback`` (the
D2H copies enqueued), ``wait`` (the host waiting for a batch's results),
``drain`` (the end of a window).
"""

from __future__ import annotations

import random
import time

import torch

from portbench import compare, inputs
from portbench import trace as tr
from portbench.reference.model import networks as reference_nets
from portbench.reference import precision
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train

_METRIC_KEYS = ("mae", "mse", "psnr", "ssim")


def _load(module: torch.nn.Module, weights: dict, what: str) -> None:
    """Load the seeded weights into a program module; every parameter must
    be among them."""
    params = {n for n, _ in module.named_parameters()}
    if params != set(weights):
        raise RuntimeError(f"{what}: parameters {sorted(params ^ set(weights))[:6]} differ "
                           "between the program and the reference")
    module.load_state_dict(weights, strict=False)


class _Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class _Cell:
    """What a run keeps for the readers: the window's frames and seconds,
    latencies, spans, kernel calls and the profiled summary."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, spans):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = spans
        self.batch = traffic["batch"]
        self.hw = (config["height"], config["width"])
        self.frames, self.window_s, self.latencies = 0, 0.0, []
        self.summary: dict = {}
        self.calls: dict = {}
        self.peak_bytes = 0
        self.setup_s = 0.0
        self.specs = inputs.weight_specs(reference_nets(config["model"]))

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def begin_window(self) -> None:
        """Set-up's work finished and the peak reset: the window starts."""
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def end_window(self) -> None:
        self.peak_bytes = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def trace(self, wraps, attempts: int = 3) -> None:
        """The per-layer readings after the window: a profiled sub-window
        of the same loop, the program functions of ``wraps`` in kernel
        ranges (``trace.KernelCalls``)."""
        from torch.profiler import ProfilerActivity, profile

        calls = tr.KernelCalls()
        calls.install(wraps)
        self.spans.traced = True
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        try:
            # The profiler now and then records no kernel in a window: such a
            # window is profiled again, up to ``attempts`` times in all.
            for _ in range(attempts):
                calls.calls.clear()
                with profile(activities=acts) as prof:
                    self.profile_window()
                    self.sync()
                self.summary = tr.summarize(prof)
                del prof
                if not self.cuda or tr.complete(self.summary, calls.calls):
                    break
        finally:
            calls.restore()
            self.spans.traced = False
        self.calls = {k: list(v) for k, v in calls.calls.items()}

    def port_config(self, **kw):
        from ircolor_tpu_torch.config import Config

        return Config.from_dict(dict(self.config["port_config"])).replace(**kw)

    def reference(self):
        """The reference's networks on the device with the seed's weights,
        float32, TF32 off."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        nets = reference_nets(self.config["model"], self.device)
        for key, w in inputs.make_weights(self.specs, self.seed, self.device).items():
            nets[key].load_state_dict(w)
        return nets


class Serve(_Cell):
    kind = "serve"

    def setup(self) -> None:
        from ircolor_tpu_torch.eval.runner import make_infer_fn
        from ircolor_tpu_torch.models.wrapper import IRColorizationModel

        b, t = self.batch, self.traffic
        cfg = self.port_config(mode="test", test_batch_size=b)
        if (cfg.resolved_hw, cfg.resolved_test_batch_size, cfg.resolved_quant_int8) != (
                self.hw, b, t["int8"]):
            raise RuntimeError(f"the config resolves to {cfg.resolved_hw} b"
                               f"{cfg.resolved_test_batch_size} int8={cfg.resolved_quant_int8}, "
                               f"not {self.hw} b{b} int8={t['int8']}")
        self.model = IRColorizationModel(cfg, self.device)
        _load(self.model.module, inputs.make_weights(self.specs, self.seed, self.device)["g"], "G")
        self.infer = make_infer_fn(self.model.module)
        self.pool = inputs.make_frames(self.seed, t["pool_batches"], b, self.hw, self.device,
                                       pin=self.cuda)
        self.sample = None
        self.loop(lambda i, _: i >= t["warmup_batches"])

    def _enqueue(self, i: int):
        ir_h, gt_h = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        with self.spans("upload"):
            ir = ir_h.to(self.device, non_blocking=True)
            gt = gt_h.to(self.device, non_blocking=True)
        with self.spans("step"):
            pred, m = self.infer(ir, gt)
        with self.spans("readback"):
            stacked = torch.stack([m[k].float() for k in _METRIC_KEYS])
            pred_h = torch.empty(pred.shape, dtype=pred.dtype, pin_memory=self.cuda)
            m_h = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=self.cuda)
            pred_h.copy_(pred, non_blocking=True)
            m_h.copy_(stacked, non_blocking=True)
            ready = torch.cuda.Event() if self.cuda else None
            if ready is not None:
                ready.record()
        return i, t0, pred_h, m_h, ready

    def _finish(self, item) -> float:
        i, t0, pred_h, m_h, ready = item
        with self.spans("wait"):
            if ready is not None:
                ready.synchronize()
        done = time.perf_counter()
        self.latencies.append(done - t0)
        b, (h, w) = self.batch, self.hw
        if (pred_h.shape != (b, h, w, 3) or pred_h.dtype != torch.uint8
                or not bool(torch.isfinite(m_h).all())):
            self.failed += 1
        if self.sample is not None:
            self.sample.offer((i % len(self.pool), pred_h, m_h))
        return done

    def loop(self, stop) -> tuple[int, float, float]:
        """Batches until ``stop(batches enqueued, seconds since start)``,
        then the last one drained: (batches, start, last arrival)."""
        self.latencies, self.failed = [], 0
        in_flight, i, done = None, 0, 0.0
        t0 = time.perf_counter()
        while not stop(i, time.perf_counter() - t0):
            item = self._enqueue(i)
            if in_flight is not None:
                done = self._finish(in_flight)
            in_flight, i = item, i + 1
        if in_flight is not None:
            with self.spans("drain"):
                done = self._finish(in_flight)
        return i, t0, done

    def window(self, seconds: float, trace: bool = False) -> None:
        self.sample = _Reservoir(self.traffic["checked_batches"], self.seed)
        n, t0, t1 = self.loop(lambda i, t: t >= seconds)
        self.attempted, self.frames, self.window_s = n, n * self.batch, t1 - t0
        self.window_latencies, self.window_failed = self.latencies, self.failed
        self.kept, self.sample = self.sample.items, None

    def profile_window(self) -> None:
        self.loop(lambda i, _: i >= self.traffic["profile_batches"])
        self.latencies, self.failed = self.window_latencies, self.window_failed

    def release(self) -> None:
        del self.model, self.infer

    def outputs(self):
        """The sampled batches: (pool index, uint8 prediction, metrics)."""
        return [(j, pred, {k: m[n] for n, k in enumerate(_METRIC_KEYS)})
                for j, pred, m in self.kept]

    def check(self, outputs=None, control: str | None = None, detail: bool = False) -> dict:
        """The comparison numbers of ``outputs`` (default: the sampled
        window batches) against the reference; ``control``: the
        configuration's lower precision put in the program's place, at the
        conv sites that the mix's route runs in int8."""
        nets = self.reference()
        quant = precision.CONTROLS[control] if control else None
        chunk = self.traffic["reference_chunk"]
        preds, ms, rpreds, rms, jms = [], [], [], [], []
        for j, pred, m in (outputs if outputs is not None else self.outputs()):
            ir, gt = self.pool[j]
            rp, rm = ref_serve.serve(nets["g"], ir, gt, chunk)
            if quant is not None:
                pred, m = ref_serve.serve(nets["g"], ir, gt, chunk, quant,
                                          tuple(self.traffic["int8_sites"]))
            preds.append(pred)
            ms.append(m)
            rpreds.append(rp)
            rms.append(rm)
            if detail:
                jms.append(ref_serve.judge_metrics(pred, gt, self.device, chunk))

        def cat(dicts):
            return {k: torch.cat([d[k].double().cpu() for d in dicts]) for k in _METRIC_KEYS}

        args = (torch.cat(preds), cat(ms), torch.cat(rpreds), cat(rms))
        numbers = compare.serve_numbers(*args)
        if detail:
            numbers["detail"] = compare.serve_detail(*args, cat(jms))
        return numbers


class Train(_Cell):
    kind = "train"

    def _make_step(self, cfg):
        from ircolor_tpu_torch.train.step import make_train_step

        return make_train_step(cfg, self.vgg)

    def setup(self) -> None:
        from ircolor_tpu_torch.losses.vgg import VGG16Features
        from ircolor_tpu_torch.train.state import create_train_state

        b, t, hp = self.batch, self.traffic, self.config["train_hp"]
        cfg = self.port_config(mode="train", batch_size=b)
        mine = dict(lr=cfg.lr_G, beta1=cfg.beta1, beta2=cfg.beta2, lambda_L1=cfg.lambda_L1,
                    lambda_perc=cfg.lambda_perc, lambda_tv=cfg.lambda_tv,
                    lambda_ssim=cfg.lambda_ssim, lambda_gan=cfg.lambda_gan)
        if mine != hp or cfg.lr_D != hp["lr"]:
            raise RuntimeError(f"the program's hyperparameters {mine} are not the reference's {hp}")
        self.state = create_train_state(cfg, steps_per_epoch=10**9, device=self.device)
        weights = inputs.make_weights(self.specs, self.seed, self.device)
        _load(self.state.g, weights["g"], "G")
        _load(self.state.d, weights["d"], "D")
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg.compute_dtype]
        self.vgg = VGG16Features(dtype)
        _load(self.vgg, weights["vgg"], "VGG")
        self.vgg.to(self.device)
        self.step_fn = self._make_step(cfg)
        self.pool = inputs.make_frames(self.seed, t["pool_batches"], b, self.hw, self.device,
                                       pin=self.cuda)
        self.beta1 = cfg.beta1
        self.readings = self._checked_steps(t["checked_steps"])

    def _named(self) -> dict[str, torch.nn.Parameter]:
        return {f"{k}.{n}": p for k, net in (("g", self.state.g), ("d", self.state.d))
                for n, p in net.named_parameters()}

    def _step(self, i: int) -> dict:
        ir_h, rgb_h = self.pool[i % len(self.pool)]
        with self.spans("upload"):
            batch = {"ir": ir_h.to(self.device, non_blocking=True),
                     "rgb": rgb_h.to(self.device, non_blocking=True)}
        with self.spans("step"):
            self.state, m = self.step_fn(self.state, batch)
        return m

    def _checked_steps(self, n: int) -> dict:
        """The first ``n`` steps, through the window's call and feed: each
        step's losses, step 1's gradients as Adam holds them (its first
        moment over 1 - beta1; kept on the host) and the change of every
        leaf after step n."""
        named = self._named()
        start = {k: p.detach().clone() for k, p in named.items()}
        losses, grad1, grad1_full = [], {}, {}
        for i in range(n):
            m = self._step(i)
            losses.append({k: m[k] for k in ref_train.LOSS_KEYS})
            if i == 0:
                for k, p in named.items():
                    st = (self.state.opt_g.state if k.startswith("g.") else self.state.opt_d.state)
                    g = st.get(p, {}).get("exp_avg")
                    g = torch.zeros_like(p) if g is None else g / (1.0 - self.beta1)
                    grad1_full[k] = g.detach().to("cpu", copy=True)
                    grad1[k] = float(g.norm())
        change = {k: float((p.detach() - start[k]).norm()) for k, p in named.items()}
        del start
        self.next_step = n
        return {"losses": [{k: float(v) for k, v in m.items()} for m in losses],
                "grad1": grad1, "grad1_full": grad1_full, "change": change}

    def loop(self, stop) -> tuple[int, float, float]:
        losses = []
        i, t0 = 0, time.perf_counter()
        while not stop(i, time.perf_counter() - t0):
            losses.append(self._step(self.next_step)["loss_G"])
            self.next_step += 1
            i += 1
        with self.spans("drain"):
            self.sync()
        t1 = time.perf_counter()
        self.failed = int(not bool(torch.isfinite(torch.stack(losses)).all())) if losses else 0
        return i, t0, t1

    def window(self, seconds: float, trace: bool = False) -> None:
        n, t0, t1 = self.loop(lambda i, t: t >= seconds)
        self.attempted, self.frames, self.window_s = n, n * self.batch, t1 - t0
        self.window_failed = self.failed

    def profile_window(self) -> None:
        self.loop(lambda i, _: i >= self.traffic["profile_steps"])
        self.failed = self.window_failed

    def release(self) -> None:
        del self.state, self.vgg, self.step_fn

    def check(self, readings=None, control: str | None = None, keep: float = 1.0,
              detail: bool = False) -> dict:
        """The comparison numbers of ``readings`` (default: the program's
        checked steps) against the reference's same steps; ``control``: the
        configuration's lower precision put in the program's place;
        ``keep`` < 1: the reference trained on part of each batch put in
        the program's place (a planted fault)."""
        batches = self.pool[:self.traffic["checked_steps"]]
        hp = self.config["train_hp"]
        if control is not None or keep < 1.0:
            nets = self.reference()
            quant = precision.CONTROLS[control] if control else None
            readings = ref_train.run(nets["g"], nets["d"], nets["vgg"], batches, hp, quant, keep)
            del nets
        nets = self.reference()
        ref = ref_train.run(nets["g"], nets["d"], nets["vgg"], batches, hp)
        prog = readings if readings is not None else self.readings
        numbers = compare.train_numbers(prog, ref)
        if detail:
            numbers["detail"] = compare.train_detail(prog, ref)
        return numbers


KINDS = {"serve": Serve, "train": Train}


def kind(name: str):
    """The cell class of a traffic ``kind``."""
    return KINDS[name]
