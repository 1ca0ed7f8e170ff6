"""ResNet-bottleneck U-Net generator (``ircolor_tpu/models/generator.py``),
inference and training, with the variants its ``Config`` and module API
reach.

  encoder    inc: ReflectPad3 + 7×7 conv 1→64 + norm + ReLU
             down1/down2: 3×3 conv + norm + ReLU + blur-pool /2
               (``no_antialias``: a stride-2 3×3 conv, no blur-pool)
  bottleneck n_blocks × ResnetBlock(256) (``remat``: each recomputed in
             the backward, ``torch.utils.checkpoint``)
  decoder    up1/up2: AA-upsample ×2 (``no_antialias_up``: a 3×3 stride-2
             ConvTranspose, output_padding 1) → conv over concat(skip) +
             norm + ReLU
             outc: ReflectPad3 + 7×7 conv 64→3 + tanh

``norm``: ``instance`` (the default; parameterless), ``batch``
(``models.common.BatchNorm``: the JAX package's flax arithmetic under
``nn.BatchNorm2d``'s state) or ``none``. The resnet blocks also take
``padding_type`` (``reflect`` | ``replicate`` | ``zero``) and
``use_dropout`` (0.5 between the convs): through the module API only, as in
the JAX package, whose wrapper fixes reflect and no dropout.

Activations are NHWC tensors (``ops.layout``). The ``nn.Sequential``
containers exist to give the parameters the reference state_dict names
(``inc.1``, ``down1.0``, ``resblocks.{i}.conv_block.{1,5}``, ``up1_conv.0``,
``outc.1``, the norms ``inc.2``, ``down1.1``, ..., ``up1_up`` for a
ConvTranspose, ...); ``forward`` applies their members itself.

Routing is the JAX generator's, flag for flag and gate for gate (the area,
launch and small-batch-band gates, the channel alignment checks,
``_fused_dtype_ok``, ``pallas_fits``, ``seg_tile_h``), minus
``_pallas_available``: routing does not depend on the device. The kernel
wrappers dispatch on the tensor's device instead (CPU → plain version,
CUDA → the kernel or an error), so the CPU tests run the exact routing the
card runs. The module-level names ``_fused_dtype_ok``,
``resnet_block_pallas``, ``resnet_block_pallas_q``, ``norm_relu_blur_down``,
``outc_head``, ``instance_norm_auto`` and ``conv_in_relu_fused`` match the
JAX module's, so a test can monkeypatch both packages the same way.

``use_pallas`` routes every instance norm the fused kernels leave (inc, the
down stages where the tails do not fuse, the unfused blocks, up1, up2 where
the head does not fuse) through ``instance_norm_auto`` (kernel 11 where its
gate admits the shape, in any dtype). ``pallas_encdec_bwd`` runs down1,
down2 and up1 as ``conv_in_relu_fused`` in training (``self.training``),
bf16, where the segment gate holds; it takes precedence over the fused
tails.

int8 serving (``quant_int8``) follows the JAX generator too: int8 inside
the fused blocks where they engage; the int8 route of ``QuantConv``
(``quant_conv_nhwc``) in down1, down2 (stride 2 under ``no_antialias``) and
the unfused blocks, and the int8 ``concat_conv3x3`` in up1 and up2,
wherever neither the fused tails nor the fused head engage
(``_quant_convs``: batch 1 at 512×640, small planes, and every batch where
the norm is not instance norm, which gates every fused kernel off);
``quant_fixed_u2`` (the fixed-scale up2 conv, where the fused kernels took
int8 off the decoder) and ``quant_head`` (the int8 head) as opt-in modes.
inc, the ConvTranspose ups and the float 7×7 head stay float.

Spatial test mode (``spatial_mesh``, the JAX field): with a 1-D H mesh
(``parallel/spatial.py``: an ordered list of devices) the forward takes and
returns a list of H-shards: equal ones in, and after each stride-2 stage
shard i holds the output rows r with 2r among its input rows (a stage's
shards may differ by a row; H need only divide by the shard count, as in
JAX, while the bottleneck keeps a row a shard). inc and outc read 3-row
reflect halos, down1, down2, up1 and up2 1-row zero halos, the blur-pools
1-row halos with the stride-2 phase kept global, the upsample its global
grid, re-cut to the skip's shards; every instance norm and int8 amax is
reduced across shards. The resnet blocks take their fused route per shard
where the bottleneck's shards are equal and the JAX per-shard gate holds
(the shard's rows ``local_h``, and ``_SP_BAND_MIN_AREA`` in the b2–7
band): the halo forms of the block convs
(``resnet_block_pallas(_q)_spatial``); unequal shards keep them off, as
JAX's ``local_h = 0`` does where the rows do not divide. The norm-blur
tails and the head stay off (``check_spatial_compat``). Spatial training
(``sp_devices`` > 1 in ``train``) runs the same forward in ``.train()``
with every fused kernel off, as JAX's does (``train.state.train_config``);
autograd of the shard ops is its backward, and ``remat`` recomputes each
block over its shards.

Every variant runs on shards, as JAX's GSPMD runs the unchanged model
function: batch norm by the whole batch's statistics across the shards
(``BatchNorm.forward_spatial``; eval: the running statistics), no norm,
``no_antialias`` (the stride-2 down convs by the same owner rule as the
blur-pool, float through ``conv_nhwc_window_spatial``, int8 through the
stride-2 int8 conv on each shard's slab), ``no_antialias_up`` (the
ConvTranspose on each shard with one halo row below, then cut as the
skip's shards), the blocks' replicate and zero pads (their halos),
dropout (the mask drawn in the whole activation's shape, each shard its
rows) and ``use_pallas`` (every instance norm through row 11h, kernel
11's shard form, where ``pallas_fits`` admits the global shape). The fused
halo blocks keep JAX's gate: instance norm, reflect pads, no dropout.

With a 2-D H×W mesh (``spatial_mesh`` a list of rows of devices; test mode's
``sp_w_devices``) the forward takes and returns a grid of tiles: equal
tiles in, and after each stride-2 stage the owner rule in both axes
(``parallel/spatial.py``), so H need only divide by the mesh's rows and W
by its columns, while the bottleneck keeps a row and a column a tile. Every
op above runs on the tiles with halo rows, columns and corners (halo
columns first, then rows, as GSPMD exchanges them), every reduction over
every tile in tile order, each upsample cut as its skip's tiles, and every
variant as on the 1-D mesh, with ``use_pallas`` through row 11h's tile
form. The fused blocks, the tails and the head stay off, as JAX's runner
turns them off on a 2-D mesh (``check_spatial_compat``); int8 serving runs
the int8 conv at every enc/dec and block conv site on 2-D slabs.

Both forwards mark their stages as spans while a profiler records
(``utils.timing.span``): ``g.inc``, ``g.down1``, ``g.down2``, ``g.blocks``,
``g.up1``, ``g.up2`` and ``g.head`` (up2's norm and ReLU, fused into the
head kernel or not, the 7×7 conv and tanh).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ircolor_tpu_torch.kernels.blur import norm_blur_supported, norm_relu_blur_down
from ircolor_tpu_torch.kernels.encdec import conv_in_relu_fused, seg_tile_h
from ircolor_tpu_torch.kernels.head import head_supported, outc_head, outc_head_q
from ircolor_tpu_torch.kernels.instance_norm import instance_norm_auto, instance_norm_auto_spatial
from ircolor_tpu_torch.kernels.resblock import (
    resnet_block_pallas,
    resnet_block_pallas_q,
    resnet_block_pallas_q_spatial,
    resnet_block_pallas_spatial,
)
from ircolor_tpu_torch.models.common import (
    apply_norm,
    apply_norm_spatial,
    concat_conv3x3,
    concat_conv3x3_spatial,
    conv_nhwc,
    conv_nhwc_spatial,
    conv_nhwc_window_spatial,
    conv_transpose_spatial,
    frozen_running_stats,
    init_module_,
    make_norm,
    norm_nhwc,
    quant_conv_nhwc,
    quant_conv_nhwc_spatial,
    use_bias_for_norm,
)
from ircolor_tpu_torch.ops.blurpool import (
    blur_downsample,
    blur_downsample_spatial,
    blur_upsample_aa,
    blur_upsample_aa_spatial,
)
from ircolor_tpu_torch.ops.filters import binomial_filter_2d
from ircolor_tpu_torch.ops.layout import to_nchw, to_nhwc
from ircolor_tpu_torch.ops.padding import pad2d, reflect_pad2d
from ircolor_tpu_torch.ops.resize import bilinear_align_corners, bilinear_align_corners_spatial
from ircolor_tpu_torch.parallel.spatial import (
    as_grid,
    check_spatial_compat,
    check_stage_heights,
    from_grid,
    image_shape,
    on_shards,
    reshard_hw,
    tile_sizes,
    tile_starts,
    tiled,
    tiles,
)
from ircolor_tpu_torch.utils.timing import span


def _fused_dtype_ok(dtype) -> bool:
    """The fused kernels are bf16-only; the f32 parity path keeps two-pass
    IN statistics. Tests monkeypatch this to run the kernel routes in f32."""
    return dtype == torch.bfloat16


def _fused_tile_h(h: int) -> int | None:
    for th in (32, 16, 8, 4):
        if h % th == 0:
            return th
    return None


# The JAX package's gates, copied as they are (H100-tuned gates are later
# work): plane and launch floors of the fused blocks, the int8 blocks' lower
# plane floor, and the small-batch band where every fused kernel engages.
_FUSED_MIN_AREA = 12288
_FUSED_MIN_LAUNCH = 40960
_QUANT_FUSED_MIN_AREA = 4096
# The smallest per-shard bottleneck plane at which the b2–7 band engages
# the fused blocks under spatial sharding (the JAX gate, probed on TPUs).
_SP_BAND_MIN_AREA = 5120


def _xla_smallbatch_band(b: int) -> bool:
    return 2 <= b <= 7


def _hwio(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """OIHW weight → HWIO in the compute dtype; autograd carries dk back
    through the cast and the permute."""
    return conv.weight.permute(2, 3, 1, 0).to(dtype)


class _Blur(nn.Module):
    """Holds the reference's fixed binomial ``filt`` buffer (state_dict
    compatibility); the blur itself is ``ops.blurpool``."""

    def __init__(self, channels: int):
        super().__init__()
        filt = torch.from_numpy(binomial_filter_2d(3))
        self.register_buffer("filt", filt[None, None].repeat(channels, 1, 1, 1))


_PRE_PADS = {"reflect": nn.ReflectionPad2d, "replicate": nn.ReplicationPad2d}
_DROP = 0.5


def dropout_keep(shape: tuple, device: torch.device,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """The block dropout's keep mask (``nn.Dropout(0.5)``: each value kept
    with probability 1/2), a bool tensor of ``shape`` drawn on
    ``generator``'s device (``device`` without one: its default generator)
    and moved to ``device``."""
    dev = device if generator is None else generator.device
    return (torch.rand(shape, device=dev, generator=generator) >= _DROP).to(device)


def remat_contexts(block: nn.Module):
    """``checkpoint``'s ``context_fn`` for one block: no batch norm updates
    its running statistics again in the recompute, and a block dropout
    generator (``ResnetBlock.dropout_generator``) replays the draw of the
    forward (``checkpoint`` replays only the devices' default
    generators)."""
    gen = getattr(block, "dropout_generator", None)
    state = {}

    @contextlib.contextmanager
    def forward():
        if gen is not None:
            state["before"] = gen.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        with frozen_running_stats(block):
            if gen is None:
                yield
                return
            after = gen.get_state()
            gen.set_state(state["before"])
            try:
                yield
            finally:
                gen.set_state(after)

    return forward(), recompute()


class ResnetBlock(nn.Module):
    """pad → 3×3 conv → norm → ReLU → [dropout] → pad → 3×3 conv → norm, + x.

    ``conv_block`` is the reference's ``build_conv_block`` Sequential: a pad
    module before each conv for reflect and replicate padding (zero pads
    inside the conv), dropout after the first ReLU, so the convs sit at 1
    and 5 by default (0 and 3 for zero padding; one later with dropout).

    Dropout in training drops by ``dropout_keep``'s mask, drawn in the whole
    activation's shape from ``dropout_generator`` (None: the device's
    default generator), so the sharded block (each shard takes its rows of
    the mask) and the unsharded one drop the same values from the same
    generator state."""

    dropout_generator: torch.Generator | None = None

    def __init__(
        self,
        dim: int,
        *,
        padding_type: str = "reflect",
        norm: str = "instance",
        use_dropout: bool = False,
        use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        pallas_block: bool = False,
        pallas_block_min_area: int = _FUSED_MIN_AREA,
        pallas_block_min_launch: int = _FUSED_MIN_LAUNCH,
        pallas_block_bwd: str = "xla",
        quant_int8: bool = False,
        use_pallas: bool = False,
    ):
        super().__init__()
        if padding_type not in (*_PRE_PADS, "zero"):
            raise NotImplementedError(f"Padding [{padding_type}] is not implemented")
        self.dim = dim
        self.padding_type = padding_type
        self.norm = norm
        self.use_dropout = use_dropout
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.pallas_block = pallas_block
        self.pallas_block_bwd = pallas_block_bwd
        self.pallas_block_min_area = pallas_block_min_area
        self.pallas_block_min_launch = pallas_block_min_launch
        self.quant_int8 = quant_int8
        pre = _PRE_PADS.get(padding_type)
        layers: list[nn.Module] = []
        for i in range(2):
            if pre is not None:
                layers.append(pre(1))
            layers.append(nn.Conv2d(dim, dim, 3, padding=0 if pre else 1, bias=use_bias))
            layers.append(make_norm(norm, dim))
            if i == 0:
                layers.append(nn.ReLU(True))
                if use_dropout:
                    layers.append(nn.Dropout(0.5))
        self.conv_block = nn.Sequential(*layers)
        convs = [j for j, m in enumerate(layers) if isinstance(m, nn.Conv2d)]
        self._conv_idx = tuple(convs)

    @property
    def conv1(self) -> nn.Conv2d:
        return self.conv_block[self._conv_idx[0]]

    @property
    def conv2(self) -> nn.Conv2d:
        return self.conv_block[self._conv_idx[1]]

    @property
    def quant(self) -> bool:
        """int8 is inference-only, as in the JAX block (``quant_int8 and not
        train``): rounding has no gradient, so a training call runs float."""
        return self.quant_int8 and not self.training

    def fused(self, x: torch.Tensor, sp_n: int = 1) -> bool:
        """The JAX ResnetBlock's fused-route gate for ``x``, the whole input
        or (``sp_n`` > 1) one of its ``sp_n`` H-shards: the plane gates
        take the shard's rows, and the b2–7 band needs a shard plane of
        ``_SP_BAND_MIN_AREA``."""
        b, h, w, c = x.shape
        quant = self.quant
        min_area = (
            min(self.pallas_block_min_area, _QUANT_FUSED_MIN_AREA)
            if quant
            else self.pallas_block_min_area
        )
        return (
            self.norm == "instance"
            and self.pallas_block
            and not self.use_dropout
            and self.padding_type == "reflect"
            and _fused_dtype_ok(self.dtype)
            and _fused_tile_h(h) is not None
            and w % 8 == 0
            and c % 128 == 0
            and self.dim % 128 == 0
            and (
                (h * w >= min_area and b * h * w >= self.pallas_block_min_launch)
                or (_xla_smallbatch_band(b) and (sp_n == 1 or h * w >= _SP_BAND_MIN_AREA))
            )
        )

    def _conv(self, layer: nn.Conv2d, y: torch.Tensor) -> torch.Tensor:
        """The JAX block's ``conv``: pre-pad (reflect, replicate) then VALID,
        or the zero-padded conv; on the int8 route a reflect pad is the int8
        conv's own (the same sums: quantizing the padded input gives the
        same grid), a replicate pad is made first and convolved VALID."""
        pre = self.padding_type if self.padding_type in _PRE_PADS else None
        if self.quant:
            if pre == "replicate":
                return quant_conv_nhwc(layer, pad2d(y, 1, pre), self.dtype, pad="valid")
            return quant_conv_nhwc(layer, y, self.dtype, pad=pre or "zero")
        return conv_nhwc(layer, y if pre is None else pad2d(y, 1, pre), self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, conv2 = self.conv1, self.conv2
        if self.fused(x):
            # The block's backward returns dk in the compute dtype. The
            # biases are inert through IN: no gradient.
            k1, k2 = _hwio(conv1, self.dtype), _hwio(conv2, self.dtype)
            if self.quant:
                return resnet_block_pallas_q(x, k1, k2)
            return resnet_block_pallas(x, k1, k2, bwd=self.pallas_block_bwd)

        if self.norm == "instance" and self.use_pallas and not self.use_dropout:
            # conv → IN → ReLU and conv → IN (+ x) each one kernel 11 launch
            # where its gate admits the plane.
            h = instance_norm_auto(self._conv(conv1, x), relu=True, use_pallas=True)
            return instance_norm_auto(self._conv(conv2, h), residual=x, use_pallas=True)
        n1, n2 = self._norms
        h = self._dropout([torch.relu(apply_norm(n1, self._conv(conv1, x)))])[0]
        return x + apply_norm(n2, self._conv(conv2, h))

    @property
    def _norms(self) -> tuple[nn.Module, nn.Module]:
        return self.conv_block[self._conv_idx[0] + 1], self.conv_block[self._conv_idx[1] + 1]

    def _dropout(self, hs: list) -> list:
        """Dropout of the activation held as the H-shards ``hs`` (one shard:
        the whole tensor) in training: one mask in the whole shape, each
        shard its rows (each tile of a grid its rows and columns), the kept
        values × 2; the identity in eval."""
        if not (self.use_dropout and self.training):
            return hs
        keep = dropout_keep(image_shape(hs), tiles(hs)[0].device, self.dropout_generator)
        out = [[h * keep[:, r : r + h.shape[1], c : c + h.shape[2]].to(h.device).to(h.dtype)
                * (1.0 / (1.0 - _DROP)) for h, c in zip(row, tile_starts(hs, 2))]
               for row, r in zip(as_grid(hs), tile_starts(hs, 1))]
        return from_grid(out, hs)

    def _conv_spatial(self, layer: nn.Conv2d, xs: list) -> list:
        if self.quant:
            return quant_conv_nhwc_spatial(layer, xs, self.dtype, pad=self.padding_type)
        return conv_nhwc_spatial(layer, xs, self.dtype, pad=1, pad_type=self.padding_type)

    def forward_spatial(self, xs: list) -> list:
        """The block over the H-shards ``xs``: the fused halo route where
        the JAX gate holds per shard on equal shards (instance norm,
        reflect, no dropout), else ``forward``'s unfused route on shards:
        its pads as halo rows, its norm across the shards (row 11h under
        ``use_pallas``), dropout's rows of one mask. A grid of tiles takes
        the unfused route (the halo forms exchange rows only)."""
        if (not tiled(xs) and all(x.shape[1] == xs[0].shape[1] for x in xs)
                and self.fused(xs[0], len(xs))):
            k1, k2 = _hwio(self.conv1, self.dtype), _hwio(self.conv2, self.dtype)
            blk = resnet_block_pallas_q_spatial if self.quant else resnet_block_pallas_spatial
            return blk(xs, k1, k2)
        if self.norm == "instance" and self.use_pallas and not self.use_dropout:
            h = instance_norm_auto_spatial(self._conv_spatial(self.conv1, xs), relu=True)
            return instance_norm_auto_spatial(self._conv_spatial(self.conv2, h), residuals=xs)
        n1, n2 = self._norms
        h = self._dropout(on_shards(torch.relu,
                                    apply_norm_spatial(n1, self._conv_spatial(self.conv1, xs))))
        return on_shards(torch.add, xs, apply_norm_spatial(n2, self._conv_spatial(self.conv2, h)))


class ResnetUNetGenerator(nn.Module):
    """U-Net encoder/decoder with a ResNet bottleneck (module docstring)."""

    def __init__(
        self,
        input_nc: int = 1,
        output_nc: int = 3,
        ngf: int = 64,
        n_blocks: int = 9,
        *,
        norm: str = "instance",
        use_dropout: bool = False,
        padding_type: str = "reflect",
        no_antialias: bool = False,
        no_antialias_up: bool = False,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        pallas_block: bool = False,
        pallas_block_min_area: int = _FUSED_MIN_AREA,
        pallas_block_min_launch: int = _FUSED_MIN_LAUNCH,
        pallas_block_bwd: str = "xla",
        pallas_encdec_bwd: bool = False,
        pallas_norm_blur: bool = False,
        pallas_norm_blur_min_area: int = 0,
        pallas_norm_blur_min_launch: int = 0,
        pallas_head: bool = False,
        pallas_head_min_area: int = 0,
        pallas_head_min_launch: int = 0,
        quant_int8: bool = False,
        quant_fixed_u2: bool = False,
        quant_head: bool = False,
        spatial_mesh: list | None = None,
    ):
        super().__init__()
        use_bias = use_bias_for_norm(norm)
        self.ngf = ngf
        self.n_blocks = n_blocks
        self.padding_type = padding_type
        self.use_dropout = use_dropout
        self.norm = norm
        self.no_antialias = no_antialias
        self.no_antialias_up = no_antialias_up
        self.remat = remat
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.pallas_encdec_bwd = pallas_encdec_bwd
        self.pallas_norm_blur = pallas_norm_blur
        self.pallas_norm_blur_min_area = pallas_norm_blur_min_area
        self.pallas_norm_blur_min_launch = pallas_norm_blur_min_launch
        self.pallas_head = pallas_head
        self.pallas_head_min_area = pallas_head_min_area
        self.pallas_head_min_launch = pallas_head_min_launch
        self.quant_int8 = quant_int8
        self.quant_fixed_u2 = quant_fixed_u2
        self.quant_head = quant_head
        # A 1-D H mesh or a 2-D H×W mesh (parallel.spatial.make_spatial_mesh):
        # the forward takes and returns H-shards or tiles (module docstring).
        self.spatial_mesh = spatial_mesh

        def norm_relu(c):
            return [make_norm(norm, c), nn.ReLU(True)]

        def up(c):
            if no_antialias_up:
                return nn.ConvTranspose2d(c, c, 3, 2, 1, output_padding=1, bias=use_bias)
            return _Blur(c)

        sd = 2 if no_antialias else 1
        self.inc = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7, bias=use_bias),
            *norm_relu(ngf),
        )
        self.down1 = nn.Sequential(
            nn.Conv2d(ngf, ngf * 2, 3, sd, padding=1, bias=use_bias), *norm_relu(ngf * 2)
        )
        self.down1_down = None if no_antialias else _Blur(ngf * 2)
        self.down2 = nn.Sequential(
            nn.Conv2d(ngf * 2, ngf * 4, 3, sd, padding=1, bias=use_bias), *norm_relu(ngf * 4)
        )
        self.down2_down = None if no_antialias else _Blur(ngf * 4)
        self.resblocks = nn.Sequential(*[
            ResnetBlock(
                ngf * 4, padding_type=padding_type, norm=norm, use_dropout=use_dropout,
                use_bias=use_bias, dtype=dtype, pallas_block=pallas_block,
                pallas_block_min_area=pallas_block_min_area,
                pallas_block_min_launch=pallas_block_min_launch,
                pallas_block_bwd=pallas_block_bwd, quant_int8=quant_int8,
                use_pallas=use_pallas,
            )
            for _ in range(n_blocks)
        ])
        self.up1_up = up(ngf * 4)
        self.up1_conv = nn.Sequential(
            nn.Conv2d(ngf * 4 + ngf * 2, ngf * 2, 3, padding=1, bias=use_bias),
            *norm_relu(ngf * 2),
        )
        self.up2_up = up(ngf * 2)
        self.up2_conv = nn.Sequential(
            nn.Conv2d(ngf * 2 + ngf, ngf, 3, padding=1, bias=use_bias),
            *norm_relu(ngf),
        )
        self.outc = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()
        )

    def init_weights(self, init_type: str, gain: float, gen: torch.Generator) -> None:
        init_module_(self, init_type, gain, gen)

    # --- the JAX generator's gates -----------------------------------------

    def _norm_blur_ok(self, y: torch.Tensor) -> bool:
        b, h, w, _ = y.shape
        return (
            self.pallas_norm_blur
            and self.norm == "instance"
            and not self.no_antialias
            and _fused_dtype_ok(self.dtype)
            and (
                (h * w >= self.pallas_norm_blur_min_area
                 and b * h * w >= self.pallas_norm_blur_min_launch)
                or _xla_smallbatch_band(b)
            )
            and norm_blur_supported(tuple(y.shape))
        )

    def _head_ok(self, y: torch.Tensor) -> bool:
        b, h, w, _ = y.shape
        return (
            self.pallas_head
            and self.norm == "instance"
            and _fused_dtype_ok(self.dtype)
            and (
                (h * w >= self.pallas_head_min_area
                 and b * h * w >= self.pallas_head_min_launch)
                or _xla_smallbatch_band(b)
            )
            and head_supported(tuple(y.shape))
        )

    @property
    def quant(self) -> bool:
        """The JAX ``quant = self.quant_int8 and not train``: int8 serves
        only; a module in ``.train()`` runs float."""
        return self.quant_int8 and not self.training

    def _quant_convs(self, x: torch.Tensor) -> bool:
        """The JAX ``quant_convs``: whether down1, down2, up1 and up2 take
        the int8 route — int8 on (and not training) and neither the fused
        tails nor the fused head engage for this input (neither does under
        a norm other than instance norm, nor the tails under
        ``no_antialias``)."""
        if not self.quant:
            return False
        if not _fused_dtype_ok(self.dtype):
            return True
        bb, bh, bw = x.shape[0], x.shape[1], x.shape[2]
        ngf = self.ngf
        nb_on = self.pallas_norm_blur and self.norm == "instance" and not self.no_antialias and any(
            ((hh * ww >= self.pallas_norm_blur_min_area
              and bb * hh * ww >= self.pallas_norm_blur_min_launch)
             or _xla_smallbatch_band(bb))
            and norm_blur_supported((1, hh, ww, cc))
            for hh, ww, cc in ((bh, bw, ngf * 2), (bh // 2, bw // 2, ngf * 4))
        )
        head_on = (
            self.pallas_head
            and self.norm == "instance"
            and ((bh * bw >= self.pallas_head_min_area
                  and bb * bh * bw >= self.pallas_head_min_launch)
                 or _xla_smallbatch_band(bb))
            and head_supported((1, bh, bw, ngf))
        )
        return not (nb_on or head_on)

    def _encdec_seg(self, zs: tuple, cout: int, quant_convs: bool) -> str | None:
        """The JAX ``encdec_seg``: the wgrad mode of the fused-backward
        segment for conv(concat(zs)) → IN → ReLU, or None where it does not
        engage (training only, instance norm, stride-1 down convs; dgrad
        needs the output 128-aligned, the fused wgrad every input leg —
        down1's 64-channel leg takes ``"xla"``)."""
        if not (self.training and self.pallas_encdec_bwd and self.norm == "instance"
                and not self.no_antialias and _fused_dtype_ok(self.dtype) and not quant_convs):
            return None
        h, w = zs[0].shape[1], zs[0].shape[2]
        if cout % 128 or w % 8:
            return None
        if seg_tile_h(h, w, max(cout, max(z.shape[-1] for z in zs))) is None:
            return None
        return "fused" if all(z.shape[-1] % 128 == 0 for z in zs) else "xla"

    # --- forward -------------------------------------------------------------

    def _norm_relu(self, y: torch.Tensor, layer: nn.Module | None = None) -> torch.Tensor:
        """The stage's norm (``layer``, its ``make_norm`` module; None: instance
        norm) + ReLU; instance norm through kernel 11 under ``use_pallas``."""
        if self.norm == "instance" and self.use_pallas:
            return instance_norm_auto(y, relu=True, use_pallas=True)
        return torch.relu(norm_nhwc(y) if layer is None else apply_norm(layer, y))

    def _down(self, seq: nn.Sequential, x: torch.Tensor, quant: bool) -> torch.Tensor:
        seg = self._encdec_seg((x,), seq[0].out_channels, quant)
        if seg is not None:
            return blur_downsample(conv_in_relu_fused(seg, (x,), _hwio(seq[0], self.dtype)))
        if quant:
            y = quant_conv_nhwc(seq[0], x, self.dtype)
        else:
            y = conv_nhwc(seq[0], x, self.dtype)
        if self._norm_blur_ok(y):
            return norm_relu_blur_down(y)
        y = self._norm_relu(y, seq[1])
        return y if self.no_antialias else blur_downsample(y)

    def _up(self, layer: nn.Module, y: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """×2 upsample to the skip's plane: the AA upsample, or the
        ConvTranspose in the compute dtype (flax ``ConvTranspose(dtype=...)``
        casts its input and parameters the same way), then the bilinear
        align-corners fix-up where the planes differ."""
        if self.no_antialias_up:
            dt = self.dtype
            bias = None if layer.bias is None else layer.bias.to(dt)
            y = to_nhwc(F.conv_transpose2d(
                to_nchw(y.to(dt)), layer.weight.to(dt), bias, stride=2, padding=1,
                output_padding=1))
        else:
            y = blur_upsample_aa(y)
        if y.shape[1:3] != skip.shape[1:3]:
            y = bilinear_align_corners(y, tuple(skip.shape[1:3]))
        return y

    def _blocks(self, h: torch.Tensor) -> torch.Tensor:
        """The bottleneck; with ``remat`` (and a graph to record) each block
        is recomputed in the backward instead of keeping its activations
        (the JAX ``nn.remat``; dropout replays its mask)."""
        if not (self.remat and torch.is_grad_enabled()):
            return self.resblocks(h)

        for block in self.resblocks:
            h = checkpoint(block, h, use_reentrant=False,
                           context_fn=lambda b=block: remat_contexts(b))
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """IR (B, H, W, input_nc) in [-1, 1] → RGB (B, H, W, output_nc) in
        [-1, 1], in the compute dtype; with ``spatial_mesh`` set, ``x`` and
        the result are lists of H-shards (a 2-D mesh: grids of tiles)."""
        if self.spatial_mesh is not None:
            return self._forward_spatial(x)
        dt = self.dtype
        quant_convs = self._quant_convs(x)
        dec_quant = "dynamic" if quant_convs else None

        with span("g.inc"):
            x0 = conv_nhwc(self.inc[1], reflect_pad2d(x.to(dt), 3), dt)
            x0 = self._norm_relu(x0, self.inc[2])              # (B, H, W, 64)
        with span("g.down1"):
            x1 = self._down(self.down1, x0, quant_convs)        # (B, H/2, W/2, 128)
        with span("g.down2"):
            x2 = self._down(self.down2, x1, quant_convs)        # (B, H/4, W/4, 256)
        with span("g.blocks"):
            h = self._blocks(x2)

        with span("g.up1"):
            y = self._up(self.up1_up, h, x1)
            seg = self._encdec_seg((y, x1), self.up1_conv[0].out_channels, quant_convs)
            if seg is not None:
                y = conv_in_relu_fused(seg, (y, x1), _hwio(self.up1_conv[0], dt))
            else:
                y = self._norm_relu(concat_conv3x3(self.up1_conv[0], y, x1, dt, dec_quant),
                                    self.up1_conv[1])

        with span("g.up2"):
            y = self._up(self.up2_up, y, x0)
            # The fixed-scale int8 up2 conv only where the fused kernels took
            # the dynamic int8 route off the decoder (the JAX ``quant_fixed``).
            if self.quant and not quant_convs and self.quant_fixed_u2:
                dec_quant = "fixed"
            y = concat_conv3x3(self.up2_conv[0], y, x0, dt, dec_quant)

        with span("g.head"):  # up2's norm + ReLU, the 7×7 conv, tanh
            outc = self.outc[1]
            if self._head_ok(y):
                head = outc_head_q if self.quant and self.quant_head else outc_head
                return torch.tanh(head(y, _hwio(outc, dt)) + outc.bias.to(dt))
            y = self._norm_relu(y, self.up2_conv[1])
            return torch.tanh(conv_nhwc(outc, reflect_pad2d(y, 3), dt))

    # --- spatial test mode ---------------------------------------------------

    def check_spatial_variants(self) -> None:
        """In training, raise ``ValueError`` for the fused kernels, whose
        halo forms have no backward: JAX's spatial training turns them all
        off (``train.state.train_config``). Every model variant runs on
        shards (module docstring)."""
        fused = {"pallas_block": any(b.pallas_block for b in self.resblocks),
                 "pallas_encdec_bwd": self.pallas_encdec_bwd}
        on = [k for k, v in fused.items() if v]
        if self.training and on:
            raise ValueError(f"spatial training runs no fused kernel, as in JAX: {', '.join(on)} "
                             "must be off (train.state.train_config turns them off)")

    def _check_spatial(self, xs: list) -> None:
        """What the spatial forward runs: the mesh's shard count (a 2-D
        mesh's grid), equal input shards (tiles), no fused kernel in
        training (``check_spatial_variants``). The stage rule is the
        blur-pool's for the stride-2 convs too: both give shard i the output
        rows r with 2r among its rows (a tile, the columns c with 2c among
        its columns too)."""
        mesh = self.spatial_mesh
        check_spatial_compat(self, mesh)
        grid = [len(row) for row in mesh] if tiled(mesh) else None
        if ([len(row) for row in xs] if tiled(xs) else None) != grid:
            raise ValueError(f"the spatial forward takes a grid of tiles exactly where the mesh "
                             f"is 2-D (mesh rows {grid})")
        if len(xs) != len(mesh):
            raise ValueError(f"{len(xs)} shards for a mesh of {len(mesh)} devices")
        self.check_spatial_variants()
        rows = [row[0] for row in xs] if grid else xs
        h = rows[0].shape[1]
        if any(x.shape[1] != h for x in rows):
            raise ValueError("the spatial forward takes equal H-shards (parallel.spatial.shard_h)")
        check_stage_heights(h * len(rows), len(rows), 2)  # down1, down2: a row a shard
        if grid:
            w = xs[0][0].shape[2]
            if any(x.shape[1:3] != (h, w) for row in xs for x in row):
                raise ValueError("the spatial forward takes equal tiles (parallel.spatial.shard_hw)")
            check_stage_heights(w * grid[0], grid[0], 2, axis=2)  # a column a tile

    def _norm_relu_spatial(self, ys: list, layer: nn.Module) -> list:
        """``_norm_relu`` on shards: row 11h under ``use_pallas`` (instance
        norm), else the stage's norm layer across the shards, then ReLU."""
        if self.norm == "instance" and self.use_pallas:
            return instance_norm_auto_spatial(ys, relu=True)
        return on_shards(torch.relu, apply_norm_spatial(layer, ys))

    def _down_spatial(self, seq: nn.Sequential, xs: list, quant: bool) -> list:
        conv = seq[0]
        if quant:
            ys = quant_conv_nhwc_spatial(conv, xs, self.dtype)
        elif conv.stride[0] == 2:  # no_antialias
            ys = conv_nhwc_window_spatial(conv, xs, self.dtype)
        else:
            ys = conv_nhwc_spatial(conv, xs, self.dtype, pad=1, pad_type="zero")
        ys = self._norm_relu_spatial(ys, seq[1])
        return ys if self.no_antialias else blur_downsample_spatial(ys)

    def _up_spatial(self, layer: nn.Module, ys: list, skips: list) -> list:
        """``_up`` on shards (or tiles), cut as the skip's shards (tiles).
        Per axis: where the planes match (2 × the rows, or the columns, sum
        to the skip's; every even stage size) the AA upsample gives the
        skip's cut itself and the ConvTranspose's 2·each shard's is re-cut
        to it; elsewhere the bilinear fix-up resizes across the shards."""
        heights, widths = tile_sizes(skips, 1), tile_sizes(skips, 2)
        rows_match = 2 * sum(tile_sizes(ys, 1)) == sum(heights)
        cols_match = 2 * sum(tile_sizes(ys, 2)) == sum(widths)
        if self.no_antialias_up:
            ys = conv_transpose_spatial(layer, ys, self.dtype)
            if rows_match and cols_match:
                return from_grid(reshard_hw(as_grid(ys), heights, widths), ys)
        else:
            ys = blur_upsample_aa_spatial(ys, out_heights=heights if rows_match else None,
                                          out_widths=widths if cols_match else None)
        if not (rows_match and cols_match):
            ys = bilinear_align_corners_spatial(ys, heights, out_widths=widths)
        return ys

    def _forward_spatial(self, xs: list) -> list:
        """The forward over the H-shards ``xs`` (module docstring): the plain
        route's ops and, in inference, the fused blocks, shard by shard,
        with their halos and cross-shard reductions; autograd of the shard
        ops is the training backward. A grid of tiles: the same ops tile by
        tile."""
        self._check_spatial(xs)
        dt = self.dtype
        b, gh, w, _ = image_shape(xs)
        quant_convs = self._quant_convs(torch.empty((b, gh, w, 1), device="meta"))
        dec_quant = "dynamic" if quant_convs else None

        with span("g.inc"):
            x0 = self._norm_relu_spatial(conv_nhwc_spatial(self.inc[1], xs, dt, pad=3,
                                                           pad_type="reflect"), self.inc[2])
        with span("g.down1"):
            x1 = self._down_spatial(self.down1, x0, quant_convs)
        with span("g.down2"):
            x2 = self._down_spatial(self.down2, x1, quant_convs)
        with span("g.blocks"):
            h = x2
            for block in self.resblocks:
                if self.remat and torch.is_grad_enabled():  # as ``_blocks``
                    h = list(checkpoint(
                        lambda *shards, b=block: tuple(b.forward_spatial(list(shards))),
                        *h, use_reentrant=False, context_fn=lambda b=block: remat_contexts(b)))
                else:
                    h = block.forward_spatial(h)
        with span("g.up1"):
            y = concat_conv3x3_spatial(self.up1_conv[0], self._up_spatial(self.up1_up, h, x1),
                                       x1, dt, dec_quant)
            y = self._norm_relu_spatial(y, self.up1_conv[1])
        with span("g.up2"):
            y = concat_conv3x3_spatial(self.up2_conv[0], self._up_spatial(self.up2_up, y, x0),
                                       x0, dt, dec_quant)
        with span("g.head"):
            y = self._norm_relu_spatial(y, self.up2_conv[1])
            return on_shards(torch.tanh, conv_nhwc_spatial(self.outc[1], y, dt, pad=3,
                                                           pad_type="reflect"))
