"""Spatial (image-axis) sharding of test mode and training over a 1-D H
mesh (``ircolor_tpu/parallel/spatial.py``).

The JAX package shards the image rows of one batch over a ``('sp',)`` mesh
of chips driven by one controller process: GSPMD partitions the plain
stages, and the fused resnet blocks run under ``shard_map`` with their
neighbours' halo rows and the instance-norm sums reduced across shards. The
port keeps that layout in one process: the mesh is an ordered list of
devices, an activation is a list of H-shards (shard i on device i, the
rows of every image that follow shard i − 1's; the input's shards are
equal, and each stride-2 stage gives shard i the output rows r with 2r
among its input rows, ``stride2_heights``, so a stage's shards may differ
by a row), and the generator's spatial forward (``models/generator.py``)
runs every op per shard with what it needs from the others. A shard's
global rows follow from the heights of the shards before it
(``row_starts``):

* ``exchange_halo_rows``: a convolution's or blur's rows from the shards
  that hold them, and at the global edges the image's own padding
  (reflect, zero or replicate) from the rows it mirrors or repeats;
* ``all_sum`` / ``all_max``: the instance-norm sums and the int8 per-sample
  amax, reduced in shard order on shard 0's device and sent back;
* ``window_heights`` / ``window_slabs``: the owner rule and the input rows
  of any window op at any stride (spatial training's discriminator convs,
  VGG convs and pools, the SSIM window, TV's row differences): shards may
  be unequal or empty, halos asymmetric, zero rows past the image's edges;
* ``on_shards``, ``global_sum``, ``global_mean``: per-shard ops and the
  losses' means over the whole image's count.

A device may repeat in the mesh: on one card every shard lives there and a
halo row is a copy on that card; on the CPU, as the tests run it, every
shard is a CPU tensor. Every op keeps its autograd graph (slices, copies,
sums), so training backpropagates through the shards and each parameter
gathers every shard's gradient. Only the 1-D H mesh is ported; 2-D H×W tiling
(``sp_w_devices > 1``), which runs no kernel in the JAX package, is not
(ROADMAP.md).
"""

from __future__ import annotations

import bisect
from collections.abc import Sequence

import torch

PADS = ("reflect", "zero", "replicate")


def make_spatial_mesh(n: int, devices: Sequence | None = None) -> list[torch.device]:
    """An ordered list of ``n`` devices for the H shards: by default the
    first ``n`` visible cards (raises where there are fewer, as the JAX
    mesh does); an explicit ``devices`` list may repeat a device."""
    if n < 1:
        raise ValueError(f"need at least one device for the spatial mesh, got n={n}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(f"need {n} devices for the spatial mesh, have {len(devs)}")
    return devs[:n]


def shard_h(x: torch.Tensor, mesh: Sequence[torch.device]) -> list[torch.Tensor]:
    """NHWC ``x`` → ``len(mesh)`` equal H-shards, shard i contiguous on
    ``mesh[i]``."""
    n, h = len(mesh), x.shape[1]
    if h % n:
        raise ValueError(f"height {h} must divide by the H-shard count {n}")
    return [part.to(dev).contiguous() for part, dev in zip(x.split(h // n, dim=1), mesh)]


def gather_h(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The H-shards joined back into one tensor on shard 0's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards], dim=1)


def row_starts(shards: Sequence[torch.Tensor]) -> list[int]:
    """Each shard's first global row: the heights of the shards before it,
    summed."""
    out, start = [], 0
    for x in shards:
        out.append(start)
        start += x.shape[1]
    return out


def stride2_heights(heights: Sequence[int]) -> list[int]:
    """The shard heights after a stride-2 stage over shards of ``heights``
    rows: shard i keeps the output rows r with 2r among its input rows,
    ceil(end / 2) − ceil(start / 2) of them (the stage's ceil(H / 2) rows
    in all)."""
    out, start = [], 0
    for h in heights:
        out.append(-(-(start + h) // 2) - -(-start // 2))
        start += h
    return out


def check_stage_heights(h: int, n: int, stages: int) -> list[list[int]]:
    """The shard heights of an ``h``-row image over ``n`` equal shards and
    after each of ``stages`` stride-2 stages; raises where ``h`` does not
    divide by ``n`` or a stage leaves a shard no row (its ceil(H / 2^k)
    rows must give each of the n shards one)."""
    if h % n:
        raise ValueError(f"height {h} must divide by the H-shard count {n}")
    out = [[h // n] * n]
    for k in range(stages):
        out.append(stride2_heights(out[-1]))
        if min(out[-1]) < 1:
            raise ValueError(
                f"height {h} over {n} H-shards leaves a shard no row after stride-2 stage {k + 1} "
                f"(shard rows {out[-1]}): every shard needs a row of the {sum(out[-1])} there")
    return out


def gather_rows(shards: Sequence[torch.Tensor], rows: Sequence[int], device) -> torch.Tensor:
    """The global rows ``rows`` (each inside the image) of the image whose
    H-shards are ``shards``, (B, len(rows), W, C) contiguous on ``device``:
    each run of consecutive rows of one shard, ascending or descending, is
    one slice of it (a ``range`` of step 1: one slice a shard it meets)."""
    starts = row_starts(shards)
    if isinstance(rows, range) and rows.step == 1:
        parts = [x[:, max(rows.start - s, 0) : rows.stop - s].to(device)
                 for x, s in zip(shards, starts)
                 if s < rows.stop and rows.start < s + x.shape[1]]
        return (torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]).contiguous()
    runs: list[list[int]] = []  # [shard, first local row, last, step]
    for g in rows:
        k = bisect.bisect_right(starts, g) - 1
        loc = g - starts[k]
        last = runs[-1] if runs else None
        if last and last[0] == k and abs(loc - last[2]) == 1 and last[3] in (0, loc - last[2]):
            last[2], last[3] = loc, loc - last[2]
        else:
            runs.append([k, loc, loc, 0])
    parts = []
    for k, first, last, step in runs:
        part = shards[k][:, min(first, last) : max(first, last) + 1]
        parts.append((part.flip(1) if step < 0 else part).to(device))
    return (torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]).contiguous()


def _pad_row(g: int, h: int, pad: str) -> int | None:
    """The image row that row ``g`` of its ``pad`` padding repeats (None: a
    zero row)."""
    if 0 <= g < h:
        return g
    if pad == "zero":
        return None
    if pad == "replicate":
        return min(max(g, 0), h - 1)
    return -g if g < 0 else 2 * h - 2 - g


def _halo(shards, lo: int, hi: int, h: int, pad: str, like: torch.Tensor) -> torch.Tensor:
    """Rows ``lo`` .. ``hi`` − 1 of the ``h``-row image padded by ``pad``
    on ``like``'s device, (B, hi − lo, W, C)."""
    if 0 <= lo and hi <= h:
        return gather_rows(shards, range(lo, hi), like.device)
    rows, parts, i = [_pad_row(g, h, pad) for g in range(lo, hi)], [], 0
    while i < len(rows):
        j = i
        while j < len(rows) and (rows[j] is None) == (rows[i] is None):
            j += 1
        if rows[i] is None:
            parts.append(like.new_zeros((like.shape[0], j - i, *like.shape[2:])))
        else:
            parts.append(gather_rows(shards, rows[i:j], like.device))
        i = j
    return (torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]).contiguous()


def exchange_halo_rows(shards: Sequence[torch.Tensor], r: int, pad: str = "reflect"):
    """Each shard's ``r`` rows above and below it as ``[(top, bot), ...]``,
    (B, r, W, C) contiguous tensors on the shard's device: the image's rows
    from whichever shards hold them (the neighbours', or past a neighbour
    of fewer rows, or of none), and past the image's top and bottom its
    ``pad`` (``PADS``) padding made from the rows it mirrors or repeats.
    Shards of any heights, empty ones too (their halo is the rows around
    the point where they sit); reflect needs an image of more than ``r``
    rows. With ``r`` 1 and reflect: the JAX package's
    ``_exchange_halo_rows`` (``pallas_resblock.py:1554``). Halos of other
    shapes (asymmetric, strided): ``window_slabs``."""
    if pad not in PADS:
        raise ValueError(f"pad must be one of {PADS}, got {pad!r}")
    h = sum(s.shape[1] for s in shards)
    if h < 1 or (pad == "reflect" and h <= r):
        raise ValueError(f"a {r}-row {pad} halo needs an image of at least one row and, for "
                         f"reflect, of more than {r} rows (shard rows "
                         f"{[s.shape[1] for s in shards]})")
    out = []
    for x, start in zip(shards, row_starts(shards)):
        end = start + x.shape[1]
        out.append((_halo(shards, start - r, start, h, pad, x),
                    _halo(shards, end, end + r, h, pad, x)))
    return out


def window_heights(heights: Sequence[int], k: int, stride: int, pad: int) -> list[int]:
    """The shard heights of the output of a ``k``-row window at ``stride``
    over shards of ``heights`` rows, ``pad`` rows of padding above and
    below the image (a conv's, a pool's): the owner rule of
    ``stride2_heights`` — shard i keeps the output rows r whose row
    ``stride·r`` of the unpadded image is among its rows. An output row may
    read rows of the next shards (the halo); a shard may keep none (a
    stride-1 4×4 conv takes a row off the image, and an odd row cannot
    start a 2×2 pool's window)."""
    n_out = (sum(heights) + 2 * pad - k) // stride + 1
    out, start = [], 0
    for h in heights:
        lo, hi = -(-start // stride), min(-(-(start + h) // stride), n_out)
        out.append(max(hi - lo, 0))
        start += h
    if sum(out) != max(n_out, 0):
        raise ValueError(f"a {k}-row window at stride {stride}, pad {pad} over shard rows "
                         f"{list(heights)} has output rows no shard owns")
    return out


def window_slabs(shards: Sequence[torch.Tensor], k: int, stride: int, pad: int,
                 pad_type: str = "zero") -> list[torch.Tensor | None]:
    """For each shard, the input rows its output rows of a ``k``-row window
    at ``stride`` read (``window_heights``' owner rule), as one (B, rows,
    W, C) slab on its device: its own rows, the halo rows of the shards
    that hold them (above and below, of any count, from past empty or short
    neighbours) and ``pad_type`` rows past the image's edges. None where
    the shard keeps no output row. Applied with no padding in H (and the
    op's own in W) at ``stride``, a slab gives exactly the shard's output
    rows."""
    h = sum(s.shape[1] for s in shards)
    slabs, o0 = [], 0
    for x, n in zip(shards, window_heights([s.shape[1] for s in shards], k, stride, pad)):
        if n == 0:
            slabs.append(None)
        else:
            lo = stride * o0 - pad
            slabs.append(_halo(shards, lo, stride * (o0 + n - 1) - pad + k, h, pad_type, x))
        o0 += n
    return slabs


def reshard_rows(shards: Sequence[torch.Tensor], heights: Sequence[int]) -> list[torch.Tensor]:
    """The image whose H-shards are ``shards`` cut again into shards of
    ``heights`` rows (summing to its rows, each at least one), shard i on
    ``shards[i]``'s device: each from the shards that hold its rows."""
    if sum(heights) != sum(s.shape[1] for s in shards) or min(heights) < 1:
        raise ValueError(f"cannot cut shard rows {[s.shape[1] for s in shards]} into {list(heights)}")
    if list(heights) == [s.shape[1] for s in shards]:
        return list(shards)
    out, start = [], 0
    for x, n in zip(shards, heights):
        out.append(gather_rows(shards, range(start, start + n), x.device))
        start += n
    return out


def halo_slabs(shards: Sequence[torch.Tensor], r: int, pad: str = "reflect"):
    """Each shard with its ``r`` halo rows above and below: (B, h + 2r, W, C)."""
    return [torch.cat([top, x, bot], dim=1)
            for x, (top, bot) in zip(shards, exchange_halo_rows(shards, r, pad))]


def _reduce(ts: Sequence[torch.Tensor], op) -> list[torch.Tensor]:
    dev = ts[0].device
    acc = ts[0]
    for t in ts[1:]:
        acc = op(acc, t.to(dev))
    return [acc if t.device == dev else acc.to(t.device) for t in ts]


def all_sum(ts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards' tensors, added in shard order on shard 0's
    device, one copy back on each shard's device."""
    return _reduce(ts, torch.add)


def all_max(ts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``all_sum`` with the elementwise maximum."""
    return _reduce(ts, torch.maximum)


def sharded(x) -> bool:
    """Whether ``x`` is an image held as a list of H-shards."""
    return isinstance(x, (list, tuple))


def on_shards(fn, *xs):
    """``fn`` applied shard by shard to images held as lists of H-shards,
    or once to whole tensors."""
    if sharded(xs[0]):
        return [fn(*parts) for parts in zip(*xs)]
    return fn(*xs)


def first_shard(x) -> torch.Tensor:
    """Shard 0 of a sharded image, else the tensor itself."""
    return x[0] if sharded(x) else x


def global_sum(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' tensors summed in shard order, on shard 0's device."""
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t.to(acc.device)
    return acc


def global_mean(x) -> torch.Tensor:
    """The mean of every element of the image: of a sharded one the shards'
    sums added in shard order over the whole image's count (an empty shard
    adds nothing), on shard 0's device; of a tensor ``x.mean()``."""
    if not sharded(x):
        return x.mean()
    return global_sum([s.sum() for s in x]) / sum(s.numel() for s in x)


def check_spatial_compat(module, mesh: Sequence) -> None:
    """Raise where ``module`` would miscompute under the H mesh
    (``spatial.py:86-134``): the norm-blur tail and the 7×7 head kernels
    reflect at the image's edges and have no spatial form, so they must be
    off; the generator's ``spatial_mesh`` must be this mesh. A W mesh axis
    (a mesh of rows of devices) is not ported."""
    if any(isinstance(d, (list, tuple)) for d in mesh):
        raise NotImplementedError("2-D H×W spatial tiling is not ported yet (ROADMAP.md, Queue 1)")
    if getattr(module, "pallas_norm_blur", False) or getattr(module, "pallas_head", False):
        raise ValueError(
            "spatial sharding with pallas_norm_blur=True or pallas_head=True produces "
            "wrong shard-seam pixels (the kernels reflect at the shard's own edges) — "
            "rebuild the generator with both False (the test runner does this)"
        )
    sp = getattr(module, "spatial_mesh", None)
    if sp is not None and list(sp) != list(mesh):
        raise ValueError("the generator's spatial_mesh is not this mesh")
