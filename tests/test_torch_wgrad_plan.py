"""The wgrad kernel's plan, transform pass and GEMM split, on the CPU.

``csrc/wgrad.cu`` runs only on the card; what surrounds it is Python that
these tests reach: the work split of ``_wgrad_plan``, the transform pass's
plain version, and the GEMM's plain version (per-slot partials, as the
kernel splits them), summed in the wrapper's order. The plain version of
the whole function, ``conv3x3_wgrad_fused_plain``, is held against JAX in
``test_torch_train_kernels.py`` and ``test_torch_encdec.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ircolor_tpu_torch.kernels import resblock
from ircolor_tpu_torch.ops.norm import instance_norm_stats
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FORMS = {  # (pad, mask_p, znorm)
    "reflect raw": ("reflect", False, False),
    "reflect znorm": ("reflect", False, True),
    "zero": ("zero", False, False),
    "zero mask_p": ("zero", True, False),
}


def _inputs(b, h, w, cz, co, seed=0):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)

    z, p, comp = bf16(b, h, w, cz), bf16(b, h, w, co), bf16(b, h, w, co)
    m, inv = instance_norm_stats(comp)
    zm, zi = instance_norm_stats(z)
    gm, gy = (torch.from_numpy(rng.standard_normal((b, co), dtype=np.float32)) * 0.01
              for _ in range(2))
    return z, p, comp, m, inv, gm, gy, (zm, zi)


@pytest.mark.parametrize("b,h,w,cz,co", [
    (8, 128, 160, 256, 256),   # the flagship blocks
    (8, 256, 320, 128, 256),   # down2's leg
    (8, 256, 320, 256, 128),   # up1's legs
    (2, 13, 21, 64, 128),      # an odd number of M-blocks, partial chunks
    (1, 4, 4, 384, 256),
    (3, 9, 70, 192, 384),
])
def test_plan_covers_every_tap_pixel_and_channel_once(b, h, w, cz, co, monkeypatch):
    # The plan reads nothing of the card: any query of it would raise.
    def no_card(*a, **k):
        raise AssertionError("the plan must not depend on the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    plan = resblock._wgrad_plan(b, h, w, cz, co)
    assert plan == resblock._wgrad_plan(b, h, w, cz, co)
    assert plan.cw * plan.ncob == co and plan.ncib * 64 == cz and plan.swap == (co % 256 != 0)
    tiles = plan.mtiles * plan.ncob
    assert tiles * plan.slots <= max(resblock._WG_WAVE, tiles)
    assert (plan.slots - 1) * plan.cps < plan.nchunks <= plan.slots * plan.cps
    # Every (tap, input-channel block, output-channel block, chunk) once.
    cover = np.zeros((9, plan.ncib, plan.ncob, plan.nchunks), dtype=np.int32)
    for slot, tap, ci0, co0, k0, k1 in resblock._wgrad_work(plan):
        assert k0 < k1 and 0 <= slot < plan.slots
        cover[tap, ci0 // 64, co0 // plan.cw, k0:k1] += 1
    assert (cover == 1).all()
    # The chunks tile each image's plane: every pixel lies in one chunk.
    hh, ww = plan.ntr * resblock._WG_TR, plan.ntc * resblock._WG_TC
    ids = torch.arange(b * hh * ww).reshape(b, hh, ww, 1)
    chunks = resblock._wgrad_chunks(ids, plan)
    assert sorted(chunks.flatten().tolist()) == list(range(b * hh * ww))
    assert hh - resblock._WG_TR < h <= hh and ww - resblock._WG_TC < w <= ww


@pytest.mark.parametrize("shape", [(2, 8, 32, 64, 128), (2, 13, 21, 128, 128), (1, 5, 3, 64, 256)])
@pytest.mark.parametrize("form", list(FORMS))
def test_transform_plain_matches_in_bwd_and_reflect_pad(shape, form):
    pad, mask_p, znorm = FORMS[form]
    z, p, comp, m, inv, gm, gy, zstats = _inputs(*shape, seed=1)
    zsrc, dy = resblock._wgrad_transform_plain(z, p, comp, m, inv, gm, gy,
                                               zstats if znorm else None, pad=pad, mask_p=mask_p)
    assert torch.equal(dy, resblock._in_bwd_input(p, comp, m, inv, gm, gy, mask_p))
    if pad == "zero":
        assert zsrc is z
        return
    zz = resblock._normalize_relu(z, *zstats).to(z.dtype) if znorm else z
    want = F.pad(zz.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="reflect")
    assert zsrc.dtype == torch.bfloat16
    assert torch.equal(zsrc.float(), want.permute(0, 2, 3, 1))


@pytest.mark.parametrize("shape", [(2, 13, 21, 64, 128), (1, 6, 40, 128, 256)])
@pytest.mark.parametrize("form", list(FORMS))
def test_slot_partials_sum_to_plain_wgrad(shape, form):
    """The GEMM's per-slot partials, summed over the slots in order, equal
    the plain contraction within 1e-5 of max|dk| (f32 sums in another
    order)."""
    pad, mask_p, znorm = FORMS[form]
    z, p, comp, m, inv, gm, gy, zstats = _inputs(*shape, seed=2)
    zn = zstats if znorm else None
    plan = resblock._wgrad_plan(*shape)
    assert plan.slots > 1  # the split is exercised
    zsrc, dy = resblock._wgrad_transform(z, p, comp, m, inv, gm, gy, zn, pad=pad, mask_p=mask_p)
    ws = resblock._wgrad_gemm(zsrc, dy, plan, pad=pad)
    assert ws.shape == (plan.slots, 9, shape[3], shape[4])
    got = ws.sum(dim=0).reshape(3, 3, shape[3], shape[4])
    want = resblock.conv3x3_wgrad_fused_plain(z, p, comp, m, inv, gm, gy, zn, pad=pad,
                                              mask_p=mask_p)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
