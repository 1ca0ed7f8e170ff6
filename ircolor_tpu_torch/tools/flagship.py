"""The flagship run's shared values: its config file, shapes and seed, the
synthetic frames every on-card phase reads, and the serving budget that
two serving steps' outputs are held to. ``chip_smoke.py`` and
``tools/dp_probe.py`` import them from here:

    from ircolor_tpu_torch.tools.flagship import synthetic_batches, within_budget
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ircolor_tpu_torch.config import Config

FLAGSHIP = Path(__file__).resolve().parents[2] / "configs" / "flagship_512x640.json"
B, H, W, NGF = 32, 512, 640, 64
TRAIN_B = 8
SEED = 0

# The synthetic batches already made, by (batch, plane): their generator
# and the batches so far. Every caller that asks for the first n batches of
# a shape reads the same frames, made once.
_SYNTHETIC: dict = {}


def synthetic_batches(n: int, b: int, hw: tuple = (H, W)) -> list:
    """IR-like frames (smooth gradients + a warm blob, a little sensor
    noise) with the RGB a fixed colormap of the IR, as uint16 / uint8 — the
    pattern of ``ircolor_tpu/data/synthetic.py``, made here with numpy: the
    first ``n`` batches of ``b`` frames of the stream seeded with ``SEED``
    for this shape (made once, then kept)."""
    rng, out = _SYNTHETIC.setdefault((b, hw), (np.random.RandomState(SEED), []))
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    while len(out) < n:
        ir = np.empty((b, h, w, 1), np.uint16)
        gt = np.empty((b, h, w, 3), np.uint8)
        for j in range(b):
            phase = rng.uniform(0, 2 * np.pi)
            f = 0.5 + 0.4 * np.sin(xx / w * 4 * np.pi + phase) * np.cos(yy / h * 2 * np.pi)
            cx, cy = rng.randint(0, w), rng.randint(0, h)
            f = f + 0.5 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (h / 4) ** 2))
            f = np.clip(f + rng.normal(0, 0.01, f.shape), 0, 1).astype(np.float32)
            ir[j, :, :, 0] = np.rint(f * 65535)
            rgb = np.stack([np.clip(1.5 * f - 0.2, 0, 1), np.clip(1 - np.abs(f - 0.5) * 2, 0, 1),
                            np.clip(0.9 - f, 0, 1)], axis=2)
            gt[j] = np.rint(rgb * 255)
        out.append((ir, gt))
    return out[:n]


def serving_config(**overrides) -> Config:
    """The flagship config in test mode, seeded with ``SEED``."""
    return Config.from_json(FLAGSHIP.read_text()).replace(mode="test", seed=SEED, **overrides)


def route_delta(pred_a, m_a, pred_b, m_b) -> dict:
    """How far two serving steps' uint8 predictions and per-image metrics
    lie apart."""
    d = (pred_a.int() - pred_b.int()).abs()
    out = dict(max_d=int(d.max()), mean_d=float(d.float().mean()),
               hist=[float((d <= j).float().mean()) for j in (0, 1, 2, 4)],
               dpsnr=float((m_a["psnr"] - m_b["psnr"]).abs().max()),
               dssim=float((m_a["ssim"] - m_b["ssim"]).abs().max()))
    out["text"] = (f"uint8 max|d|={out['max_d']} mean|d|={out['mean_d']:.4f}; share with "
                   f"|d|<=0/1/2/4: {', '.join(f'{h:.4f}' for h in out['hist'])}; "
                   f"|dPSNR|={out['dpsnr']:.5f} dB |dSSIM|={out['dssim']:.6f}")
    return out


def within_budget(delta: dict, uint8_bound: bool = True) -> bool:
    """The repository's int8 serving budget on the metrics (0.02 dB PSNR,
    0.002 SSIM per image), and on the uint8 image a mean difference of at
    most 2 levels with 95% of values within 4. Each kernel alone matches
    its plain version bit for bit or to one bf16 ulp (``chip_smoke.py``
    phase 2); between two routes the conv statistics, summed in another
    order, move the next conv's normalize (and, for int8, its rounding) by
    an ulp here and there, and 9 blocks of a random-weight network compound
    that, while the bf16 output grid makes one ulp of the prediction 1-2
    uint8 levels."""
    return (delta["dpsnr"] <= 0.02 and delta["dssim"] <= 0.002
            and (not uint8_bound or (delta["mean_d"] <= 2.0 and delta["hist"][3] >= 0.95)))
