"""The reference's test step on a batch of the integer transport: decode,
generator, the uint8 round trip, the per-image metrics. Float32 with TF32
off, in blocks of images so that it fits beside nothing else."""

from __future__ import annotations

import torch

from portbench.reference.losses import metrics, to_uint8_grid
from portbench.reference.model import Generator


def decode(ir_u16: torch.Tensor, gt_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC uint16 IR and uint8 RGB -> NCHW float32 IR in [-1, 1] and RGB in [0, 1]."""
    ir = ir_u16.float() / 65535.0 * 2.0 - 1.0
    gt = gt_u8.float() / 255.0
    return ir.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2)


@torch.no_grad()
def serve(g: Generator, ir_u16: torch.Tensor, gt_u8: torch.Tensor, chunk: int = 8, quant=None,
          sites: tuple = ()) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(uint8 NHWC prediction, per-image metrics) of the batch, on
    ``g``'s device, ``chunk`` images at a time; ``quant``: a control's
    rounding of the generator's convs at ``sites``."""
    dev = next(g.parameters()).device
    preds, ms = [], []
    for i in range(0, ir_u16.shape[0], chunk):
        ir, gt = decode(ir_u16[i:i + chunk].to(dev), gt_u8[i:i + chunk].to(dev))
        pred01 = to_uint8_grid((g(ir, quant, sites) + 1.0) / 2.0)
        preds.append(torch.round(pred01 * 255.0).to(torch.uint8).permute(0, 2, 3, 1).cpu())
        ms.append({k: v.double().cpu() for k, v in metrics(pred01, gt).items()})
    return torch.cat(preds), {k: torch.cat([m[k] for m in ms]) for k in ms[0]}


@torch.no_grad()
def judge_metrics(pred_u8: torch.Tensor, gt_u8: torch.Tensor, device,
                  chunk: int = 8) -> dict[str, torch.Tensor]:
    """The reference's metrics of a given uint8 NHWC prediction against the
    ground truth: what the prediction's metrics should read."""
    ms = []
    for i in range(0, pred_u8.shape[0], chunk):
        p = pred_u8[i:i + chunk].to(device).double().permute(0, 3, 1, 2) / 255.0
        gt = gt_u8[i:i + chunk].to(device).double().permute(0, 3, 1, 2) / 255.0
        ms.append({k: v.cpu() for k, v in metrics(p, gt).items()})
    return {k: torch.cat([m[k] for m in ms]) for k in ms[0]}
