"""The reference's training step (``train_kaist``, ``Code/ir_colorization.py``
1629-1681), float32: D's hinge step on [real || fake] with G's output
detached, one Adam step on D; then G's composite loss against the updated
D (lambda_gan (-E[D(fake)]) + lambda_L1 L1 + lambda_perc VGG-L1 + lambda_tv TV
+ lambda_ssim (1 - SSIM)), one Adam step on G. G runs once a step: the
reference's second, no-grad forward gives the same tensor. The VGG tower is
frozen.

``run`` follows the first steps of a seeded run and returns what the
benchmark compares: each step's losses, every leaf's first gradient norm
and every leaf's change after the last step.
"""

from __future__ import annotations

import torch

from portbench.reference.losses import hinge_d, hinge_g, ssim_loss, tv
from portbench.reference.model import Discriminator, Generator, VGGFeatures

LOSS_KEYS = ("loss_D", "loss_G")


def _decode(ir_u16: torch.Tensor, rgb_u8: torch.Tensor, dev) -> tuple[torch.Tensor, torch.Tensor]:
    ir = ir_u16.to(dev).float() / 65535.0 * 2.0 - 1.0
    rgb = rgb_u8.to(dev).float() / 255.0 * 2.0 - 1.0
    return ir.permute(0, 3, 1, 2), rgb.permute(0, 3, 1, 2)


def step(g: Generator, d: Discriminator, vgg: VGGFeatures, ir: torch.Tensor,
         rgb: torch.Tensor, hp: dict, quant=None, after_d=None,
         chunk: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One step's forwards and backwards on decoded NCHW ``ir`` and ``rgb``
    in [-1, 1], the gradients zeroed beforehand: D's hinge loss backward,
    then ``after_d()`` (D's optimizer step), then G's composite loss
    backward against D as it then is. Returns (loss_D, loss_G), detached.
    ``chunk``: the images a pass takes; with several passes the gradients
    accumulate (every loss is a mean over equal chunks, and every norm is
    per image, so the sums are the whole batch's) and G runs again, with a
    graph, in D's second phase."""
    n = ir.shape[0]
    chunk = chunk or n
    parts = [slice(i, i + chunk) for i in range(0, n, chunk)]
    k = len(parts)
    loss_d = loss_g = 0.0
    fake = None
    for p in parts:
        if k == 1:
            fake = g(ir[p], quant)
            f = fake.detach()
        else:
            with torch.no_grad():
                f = g(ir[p], quant)
        m = f.shape[0]
        pred = d(torch.cat([torch.cat([ir[p], rgb[p]], 1), torch.cat([ir[p], f], 1)]), quant)
        part = hinge_d(pred[:m], pred[m:]) / k
        part.backward()
        loss_d = loss_d + part.detach()
        del f, pred, part
    if after_d is not None:
        after_d()
    d.requires_grad_(False)
    try:
        for p in parts:
            fk = fake if k == 1 else g(ir[p], quant)
            r = rgb[p]
            total = (hp["lambda_gan"] * hinge_g(d(torch.cat([ir[p], fk], 1), quant))
                     + hp["lambda_L1"] * (fk - r).abs().mean()
                     + hp["lambda_perc"] * (vgg(fk, quant) - vgg(r, quant)).abs().mean()
                     + hp["lambda_tv"] * tv(fk)
                     + hp["lambda_ssim"] * ssim_loss((fk + 1.0) / 2.0, (r + 1.0) / 2.0)) / k
            total.backward()
            loss_g = loss_g + total.detach()
            del fk, total
    finally:
        d.requires_grad_(True)
    return loss_d, loss_g


def run(g: Generator, d: Discriminator, vgg: VGGFeatures, batches: list, hp: dict,
        quant=None, keep: float = 1.0, chunk: int | None = None) -> dict:
    """Train ``g`` and ``d`` on ``batches`` ((uint16 IR, uint8 RGB) NHWC
    pairs), one step each, with Adam (``hp``: lr, beta1, beta2, eps 1e-8)
    and the lambda_* weights of ``hp``. ``quant``: a control's rounding of
    every convolution; ``keep`` < 1 trains on that share of each batch (a
    fault the comparison must catch); ``chunk``: the images a pass takes
    (``step``). Returns {"losses": [{loss_D, loss_G}]
    a step, "grad1": {leaf: norm of step 1's gradient}, "grad1_full":
    {leaf: step 1's gradient}, "change": {leaf: norm of the change after
    the last step}}; G's leaves are prefixed "g.", D's "d."."""
    dev = next(g.parameters()).device
    nets = {"g": g, "d": d}
    start = {f"{k}.{n}": p.detach().clone() for k, net in nets.items()
             for n, p in net.named_parameters()}
    betas = (hp["beta1"], hp["beta2"])
    opt_g = torch.optim.Adam(g.parameters(), lr=hp["lr"], betas=betas, eps=1e-8)
    opt_d = torch.optim.Adam(d.parameters(), lr=hp["lr"], betas=betas, eps=1e-8)
    losses, grad1, grad1_full = [], {}, {}

    def norms(key):
        for k, p in nets[key].named_parameters():
            grad1_full[f"{key}.{k}"] = p.grad.detach().clone()
            grad1[f"{key}.{k}"] = float(p.grad.norm())

    for i, (ir_u16, rgb_u8) in enumerate(batches):
        n = max(1, int(round(ir_u16.shape[0] * keep)))
        ir, rgb = _decode(ir_u16[:n], rgb_u8[:n], dev)
        opt_d.zero_grad(set_to_none=True)
        opt_g.zero_grad(set_to_none=True)

        def after_d():
            if i == 0:
                norms("d")
            opt_d.step()

        loss_d, loss_g = step(g, d, vgg, ir, rgb, hp, quant, after_d, chunk)
        if i == 0:
            norms("g")
        opt_g.step()
        losses.append({"loss_D": float(loss_d), "loss_G": float(loss_g)})
    change = {f"{k}.{n}": float((p.detach() - start[f"{k}.{n}"]).norm())
              for k, net in nets.items() for n, p in net.named_parameters()}
    return {"losses": losses, "grad1": grad1, "grad1_full": grad1_full, "change": change}
