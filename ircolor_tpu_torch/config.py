"""Central configuration — the JAX package's ``Config`` with every field name
and default kept (but ``export_out``'s: a ``torch.export`` artifact, ``.pt2``),
so ``configs/*.json`` and the CLI flags mean the same thing in both packages
(``ircolor_tpu/config.py``).

Fields that select JAX-only machinery (meshes, XLA precision,
lane-packing, the Pallas gates) are kept for that reason; the port reads
the kernel gates exactly as the JAX generator does. Every model variant
(``norm``, ``no_antialias``, ``no_antialias_up``, ``use_pallas``) runs on
one device, over data-parallel ranks and over the 1-D H mesh
(``sp_devices``), in test mode and in training, and over the 2-D H×W mesh
(``sp_w_devices`` with ``sp_devices``) in test mode.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Config:
    # ---------- mode ----------
    mode: str = "test"  # "train" | "test" | "export"

    # ---------- model ----------
    img_size: int = 256
    input_nc: int = 1
    output_nc: int = 3
    ngf: int = 64
    norm: str = "instance"       # "instance" | "batch" | "none"
    no_antialias: bool = False
    no_antialias_up: bool = False
    n_blocks: int = 9
    init_type: str = "normal"    # "normal" | "xavier" | "kaiming" | "orthogonal"
    init_gain: float = 0.02

    # ---------- checkpoints / output dirs ----------
    save_every: int = 5
    save_dir: str = "./Weights/trained/checkpoints_kaist"
    output_dir: str = "./results"
    test_G_weights: str | None = None

    # ---------- train data ----------
    train_roots: tuple[str, ...] = (
        "kaist-dataset/versions/1/set00",
        "kaist-dataset/versions/1/set01",
        "kaist-dataset/versions/1/set03",
        "kaist-dataset/versions/1/set04",
    )

    # ---------- training hyperparameters ----------
    batch_size: int = 4
    epochs: int = 50
    lr_G: float = 2e-4
    lr_D: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    lambda_L1: float = 30.0
    lambda_perc: float = 30.0
    lambda_tv: float = 1e-4
    lambda_ssim: float = 2.0
    lambda_gan: float = 0.1
    num_workers: int = 4
    val_ratio: float = 0.1
    lr_decay_start_epoch: int = 40
    init_G_weights: str | None = None

    # ---------- test data ----------
    test_roots: tuple[str, ...] = (
        "kaist-dataset/versions/1/set02",
        "kaist-dataset/versions/1/set05",
    )

    # ---------- collage / comparisons ----------
    save_comparisons: bool = True
    comparison_dirname: str = "Comparisons"
    comparison_add_text: bool = False
    comparison_pad: int = 8
    comparison_font_scale: float = 0.6
    comparison_thickness: int = 2

    # ---------- Top-K export ----------
    best50_copy_preds: bool = True
    best50_copy_collages: bool = True
    best50_preds_subdir: str = "colored"
    best50_collages_subdir: str = "collages"
    topk: int = 50
    best50_dirname: str = "Best_50_colored_images"

    # ---------- additions of the JAX package (same names) ----------
    img_height: int | None = None
    img_width: int | None = None
    test_batch_size: int | None = None  # None → resolved_test_batch_size
    compute_dtype: str = "f32"          # "f32" parity path | "bf16" serving
    conv_precision: str = "highest"     # f32: highest = TF32 off; high, default allow it
    batch_transport: str = "int"        # uint16/uint8 transport | "float"
    dp_devices: int = 0                 # data-parallel ranks; 0: every card, fit to the batch
    sp_devices: int = 1                 # >1: test mode and training on a 1-D H mesh
    sp_w_devices: int = 1               # >1: test mode on an (sp/sp_w)×sp_w H×W mesh; train ignores it
    dp_mode: str = "gspmd"
    resume: bool = False
    orbax_dir: str | None = None
    vgg16_weights: str | None = None
    remat: bool = False
    lanepack: bool = True               # a TPU layout device; no effect here
    # Kernel routing, read exactly as the JAX generator reads it.
    use_pallas: bool = False            # fused IN kernel (kernel 11) where it fits
    pallas_block: bool = True
    pallas_block_train: bool = True
    pallas_block_bwd: str = "fused_wg"
    pallas_encdec_bwd: bool = False     # fused backward of down1, down2, up1 (training)
    pallas_norm_blur: bool = True
    pallas_norm_blur_min_area: int = 18000
    pallas_norm_blur_min_launch: int = 600000
    pallas_norm_blur_train: bool = False
    blur_matmul_bwd: bool = True
    pallas_head: bool = True
    pallas_head_min_area: int = 100000
    pallas_head_min_launch: int = 600000
    pallas_head_train: bool = False
    # int8 serving: None → resolved_quant_int8. int8 rides inside the fused
    # resnet blocks, or on the int8 conv route where the fused tails and
    # head do not engage; the fixed-scale up2 conv and the int8 head are
    # opt-in (both flags below are off by default because they failed the
    # JAX package's accuracy gate).
    quant_int8: bool | None = None
    quant_fixed_u2: bool = False
    quant_head: bool = False
    export_out: str = "netG_serving.pt2"
    export_platforms: str | None = None  # "cuda" or "cpu" (None: --device)
    export_keep_pallas: bool = False
    d_concat: bool = True
    log_every: int = 50
    jsonl_log: str | None = None
    profile_dir: str | None = None
    debug_nans: bool = False
    seed: int = 0

    # ------------------------------------------------------------------
    @property
    def resolved_hw(self) -> tuple[int, int]:
        """(H, W) the model runs at — square img_size unless overridden."""
        h = self.img_height if self.img_height is not None else self.img_size
        w = self.img_width if self.img_width is not None else self.img_size
        return h, w

    @property
    def resolved_test_batch_size(self) -> int:
        """Explicit value, else 32 for 512×640-class planes (≥200k px) and
        16 below — the JAX package's rule, kept as is."""
        if self.test_batch_size is not None:
            return max(1, self.test_batch_size)
        h, w = self.resolved_hw
        return 32 if h * w >= 200_000 else 16

    @property
    def resolved_quant_int8(self) -> bool:
        """Explicit value, else ON for bf16 serving at planes of at least
        65,536 px and OFF for the f32 parity path and for training. ON means
        the JAX package's int8 routing (``models/generator.py``): inside the
        fused resnet blocks, or the int8 conv route for down1, down2, the
        blocks, up1 and up2 where the fused tails and head do not engage;
        the fixed-scale up2 conv and the int8 head only with
        ``quant_fixed_u2``/``quant_head`` (default off)."""
        if self.quant_int8 is not None:
            return self.quant_int8
        h, w = self.resolved_hw
        return (
            self.compute_dtype == "bf16"
            and self.mode != "train"
            and h * w >= 65_536
        )

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"Unknown config fields: {sorted(unknown)}")
        for key in ("train_roots", "test_roots"):
            if key in raw and isinstance(raw[key], list):
                raw[key] = tuple(raw[key])
        return cls(**raw)
