"""Spatial (image-axis) sharding of test mode and training over a 1-D H
mesh, and of test mode over a 2-D H×W mesh (``ircolor_tpu/parallel/spatial.py``).

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

Each of the row helpers takes an ``axis``: 1 (the default) works on rows
across H-shards, 2 on columns across W-tiles.

2-D H×W tiling (test mode's ``sp_w_devices`` > 1; the JAX ``('sp', 'spw')``
mesh): the mesh is a list of Sh rows of Sw devices (JAX's reshape,
``make_spatial_mesh(n, devices, w_devices)``), and an image a grid of tiles,
a list of Sh H-shards each a list of Sw W-tiles (``shard_hw`` /
``gather_hw``). Tile (i, j) holds the rows that the owner rule gives shard
i and the columns that the same rule, applied to W, gives tile j, so tiles
may be unequal after a stride-2 stage in either axis. Halos go one axis at
a time, as GSPMD exchanges them: each tile row exchanges its halo columns
along W (the image's padding at the left and right edges), then each tile
column of the W-grown tiles exchanges halo rows along H, which brings the
corners with it (``halo_slabs``, ``window_slabs``). Reductions take the
tiles in one fixed order, row by row (``tiles``); ``on_shards`` maps over
either form.

A device may repeat in the mesh: on one card every shard lives there and a
halo row is a copy on that card; on the CPU, as the tests run it, every
shard is a CPU tensor. Every op keeps its autograd graph (slices, copies,
sums), so training backpropagates through the shards and each parameter
gathers every shard's gradient.
"""

from __future__ import annotations

import bisect
import itertools
from collections.abc import Sequence

import torch

PADS = ("reflect", "zero", "replicate")


def make_spatial_mesh(n: int, devices: Sequence | None = None, w_devices: int = 1) -> list:
    """An ordered list of ``n`` devices for the H shards: by default the
    first ``n`` visible cards (raises where there are fewer, as the JAX
    mesh does); an explicit ``devices`` list may repeat a device. With
    ``w_devices`` > 1 the 2-D mesh: those ``n`` devices as n / w_devices
    rows of ``w_devices`` (raises where they do not tile, as JAX's does)."""
    if n < 1:
        raise ValueError(f"need at least one device for the spatial mesh, got n={n}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(f"need {n} devices for the spatial mesh, have {len(devs)}")
    devs = devs[:n]
    if w_devices <= 1:
        return devs
    if n % w_devices:
        raise ValueError(f"{n} devices do not tile into w_devices={w_devices}")
    return [devs[i : i + w_devices] for i in range(0, n, w_devices)]


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


def sharded(x) -> bool:
    """Whether ``x`` is an image held as a list of H-shards (or of tile
    rows)."""
    return isinstance(x, (list, tuple))


def tiled(x) -> bool:
    """Whether ``x`` is a grid of tiles (or a 2-D mesh): a list of rows,
    each a list."""
    return sharded(x) and len(x) > 0 and sharded(x[0])


def tiles(x) -> list:
    """The tiles of a grid in tile order, row by row (the H-shards of a
    1-D image as they are): the one order of every reduction over tiles."""
    return [t for row in x for t in row] if tiled(x) else list(x)


def regrid(flat: Sequence, like) -> list:
    """``flat`` (one entry a tile, in ``tiles`` order) cut into ``like``'s
    grid; a list as it is where ``like`` is 1-D."""
    if not tiled(like):
        return list(flat)
    out, i = [], 0
    for row in like:
        out.append(list(flat[i : i + len(row)]))
        i += len(row)
    return out


def columns(grid) -> list:
    """A grid's tile columns: column j is the list of every row's entry j."""
    return [list(col) for col in zip(*grid)]


def as_grid(x) -> list:
    """A grid of tiles as it is; a list of H-shards as the grid of one tile
    column (the Sw = 1 case), so that one body serves both forms."""
    return x if tiled(x) else [[s] for s in x]


def from_grid(grid, like) -> list:
    """``grid`` in ``like``'s form: a grid, or the list of H-shards that
    ``as_grid`` made one tile column."""
    return grid if tiled(like) else [row[0] for row in grid]


def tile_sizes(x, axis: int) -> list[int]:
    """The rows of each H-shard (``axis`` 1) or the columns of each W-tile
    (``axis`` 2) of a list of H-shards or a grid of tiles (a list of
    H-shards: one W-tile, the image's width)."""
    grid = as_grid(x)
    return [row[0].shape[1] for row in grid] if axis == 1 else [t.shape[2] for t in grid[0]]


def tile_starts(x, axis: int) -> list[int]:
    """Each H-shard's first global row (``axis`` 1) or each W-tile's first
    global column (``axis`` 2): the sizes of those before it, summed."""
    return list(itertools.accumulate([0, *tile_sizes(x, axis)[:-1]]))


def image_shape(x) -> tuple:
    """(B, H, W, C) of the image held as a tensor, a list of H-shards or a
    grid of tiles."""
    if not sharded(x):
        return tuple(x.shape)
    b, _, _, c = tiles(x)[0].shape
    return (b, sum(tile_sizes(x, 1)), sum(tile_sizes(x, 2)), c)


def shard_hw(x: torch.Tensor, mesh: Sequence[Sequence[torch.device]]) -> list[list[torch.Tensor]]:
    """NHWC ``x`` → the grid of equal tiles of the 2-D ``mesh``: tile (i,
    j) contiguous on ``mesh[i][j]``. H must divide by the mesh's rows and
    W by its columns."""
    sh, sw = len(mesh), len(mesh[0])
    h, w = x.shape[1], x.shape[2]
    if h % sh:
        raise ValueError(f"height {h} must divide by the H-shard count {sh}")
    if w % sw:
        raise ValueError(f"width {w} must divide by the W-tile count {sw}")
    return [[part.to(dev).contiguous() for part, dev in zip(row.split(w // sw, dim=2), devs)]
            for row, devs in zip(x.split(h // sh, dim=1), mesh)]


def gather_hw(grid) -> torch.Tensor:
    """A grid of tiles joined back into one tensor on tile (0, 0)'s device."""
    dev = grid[0][0].device
    return torch.cat([torch.cat([t.to(dev) for t in row], dim=2) for row in grid], dim=1)


def row_starts(shards: Sequence[torch.Tensor], axis: int = 1) -> list[int]:
    """Each shard's first global row (``axis`` 2: each W-tile's first
    column): the sizes of the shards before it, summed."""
    out, start = [], 0
    for x in shards:
        out.append(start)
        start += x.shape[axis]
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


_AXIS_WORDS = {1: ("height", "H-shard", "row"), 2: ("width", "W-tile", "column")}


def check_stage_heights(h: int, n: int, stages: int, axis: int = 1) -> list[list[int]]:
    """The shard heights of an ``h``-row image over ``n`` equal shards and
    after each of ``stages`` stride-2 stages; raises where ``h`` does not
    divide by ``n`` or a stage leaves a shard no row (its ceil(H / 2^k)
    rows must give each of the n shards one). ``axis`` 2: the same for the
    widths of ``n`` W-tiles (a column a tile)."""
    size, part, unit = _AXIS_WORDS[axis]
    if h % n:
        raise ValueError(f"{size} {h} must divide by the {part} count {n}")
    out = [[h // n] * n]
    for k in range(stages):
        out.append(stride2_heights(out[-1]))
        if min(out[-1]) < 1:
            raise ValueError(
                f"{size} {h} over {n} {part}s leaves a {part[2:]} no {unit} after stride-2 stage "
                f"{k + 1} ({part[2:]} {unit}s {out[-1]}): every {part[2:]} needs a {unit} of the "
                f"{sum(out[-1])} there")
    return out


def _cut(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """``x[:, lo:hi]`` along ``axis`` (Python's slice bounds)."""
    return x[(slice(None),) * axis + (slice(lo, hi),)]


def gather_rows(shards: Sequence[torch.Tensor], rows: Sequence[int], device,
                axis: int = 1) -> torch.Tensor:
    """The global rows ``rows`` (each inside the image) of the image whose
    H-shards are ``shards``, (B, len(rows), W, C) contiguous on ``device``:
    each run of consecutive rows of one shard, ascending or descending, is
    one slice of it (a ``range`` of step 1: one slice a shard it meets).
    ``axis`` 2: the global columns of the W-tiles ``shards``."""
    starts = row_starts(shards, axis)
    if isinstance(rows, range) and rows.step == 1:
        parts = [_cut(x, axis, max(rows.start - s, 0), rows.stop - s).to(device)
                 for x, s in zip(shards, starts)
                 if s < rows.stop and rows.start < s + x.shape[axis]]
        return (torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]).contiguous()
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
        part = _cut(shards[k], axis, min(first, last), max(first, last) + 1)
        parts.append((part.flip(axis) if step < 0 else part).to(device))
    return (torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]).contiguous()


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


def _halo(shards, lo: int, hi: int, h: int, pad: str, like: torch.Tensor,
          axis: int = 1) -> torch.Tensor:
    """Rows ``lo`` .. ``hi`` − 1 of the ``h``-row image padded by ``pad``
    on ``like``'s device, (B, hi − lo, W, C) (``axis`` 2: columns)."""
    if 0 <= lo and hi <= h:
        return gather_rows(shards, range(lo, hi), like.device, axis)
    rows, parts, i = [_pad_row(g, h, pad) for g in range(lo, hi)], [], 0
    while i < len(rows):
        j = i
        while j < len(rows) and (rows[j] is None) == (rows[i] is None):
            j += 1
        if rows[i] is None:
            shape = list(like.shape)
            shape[axis] = j - i
            parts.append(like.new_zeros(shape))
        else:
            parts.append(gather_rows(shards, rows[i:j], like.device, axis))
        i = j
    return (torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]).contiguous()


def exchange_halo_rows(shards: Sequence[torch.Tensor], r: int, pad: str = "reflect",
                       axis: int = 1):
    """Each shard's ``r`` rows above and below it as ``[(top, bot), ...]``,
    (B, r, W, C) contiguous tensors on the shard's device: the image's rows
    from whichever shards hold them (the neighbours', or past a neighbour
    of fewer rows, or of none), and past the image's top and bottom its
    ``pad`` (``PADS``) padding made from the rows it mirrors or repeats.
    Shards of any heights, empty ones too (their halo is the rows around
    the point where they sit); reflect needs an image of more than ``r``
    rows. With ``r`` 1 and reflect: the JAX package's
    ``_exchange_halo_rows`` (``pallas_resblock.py:1554``). Halos of other
    shapes (asymmetric, strided): ``window_slabs``. ``axis`` 2: each W-tile's
    ``r`` columns left and right of it, ``[(left, right), ...]``."""
    if pad not in PADS:
        raise ValueError(f"pad must be one of {PADS}, got {pad!r}")
    h = sum(s.shape[axis] for s in shards)
    if h < 1 or (pad == "reflect" and h <= r):
        raise ValueError(f"a {r}-row {pad} halo needs an image of at least one row and, for "
                         f"reflect, of more than {r} rows (shard rows "
                         f"{[s.shape[axis] for s in shards]})")
    out = []
    for x, start in zip(shards, row_starts(shards, axis)):
        end = start + x.shape[axis]
        out.append((_halo(shards, start - r, start, h, pad, x, axis),
                    _halo(shards, end, end + r, h, pad, x, axis)))
    return out


def window_heights(heights: Sequence[int], k: int, stride: int, pad: int) -> list[int]:
    """The shard heights of the output of a ``k``-row window at ``stride``
    over shards of ``heights`` rows, ``pad`` rows of padding above and
    below the image (a conv's, a pool's): the owner rule of
    ``stride2_heights`` — shard i keeps the output rows r whose row
    ``stride·r`` of the unpadded image is among its rows. An output row may
    read rows of the next shards (the halo); a shard may keep none (a
    stride-1 4×4 conv takes a row off the image, and an odd row cannot
    start a 2×2 pool's window). The same rule gives W-tiles their columns."""
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


def window_slabs(shards, k: int, stride: int, pad: int, pad_type: str = "zero",
                 axis: int = 1) -> list:
    """For each shard, the input rows its output rows of a ``k``-row window
    at ``stride`` read (``window_heights``' owner rule), as one (B, rows,
    W, C) slab on its device: its own rows, the halo rows of the shards
    that hold them (above and below, of any count, from past empty or short
    neighbours) and ``pad_type`` rows past the image's edges. None where
    the shard keeps no output row. Applied with no padding in H (and the
    op's own in W) at ``stride``, a slab gives exactly the shard's output
    rows. ``axis`` 2: the same in columns over W-tiles. A grid of tiles:
    the window in both axes (a k×k window, the same stride and padding),
    the columns first, then the rows of the W-slabs, so that a slab holds
    its corners; None where the tile keeps no output row or column; applied
    with no padding at all."""
    if tiled(shards):
        wide = [window_slabs(row, k, stride, pad, pad_type, axis=2) for row in shards]
        cols = [[None] * len(col) if col[0] is None else window_slabs(col, k, stride, pad, pad_type)
                for col in columns(wide)]
        return columns(cols)
    h = sum(s.shape[axis] for s in shards)
    slabs, o0 = [], 0
    for x, n in zip(shards, window_heights([s.shape[axis] for s in shards], k, stride, pad)):
        if n == 0:
            slabs.append(None)
        else:
            lo = stride * o0 - pad
            slabs.append(_halo(shards, lo, stride * (o0 + n - 1) - pad + k, h, pad_type, x, axis))
        o0 += n
    return slabs


def reshard_rows(shards: Sequence[torch.Tensor], heights: Sequence[int],
                 axis: int = 1) -> list[torch.Tensor]:
    """The image whose H-shards are ``shards`` cut again into shards of
    ``heights`` rows (summing to its rows, each at least one), shard i on
    ``shards[i]``'s device: each from the shards that hold its rows.
    ``axis`` 2: W-tiles cut again into tiles of ``heights`` columns."""
    sizes = [s.shape[axis] for s in shards]
    if sum(heights) != sum(sizes) or min(heights) < 1:
        raise ValueError(f"cannot cut shard rows {sizes} into {list(heights)}")
    if list(heights) == sizes:
        return list(shards)
    out, start = [], 0
    for x, n in zip(shards, heights):
        out.append(gather_rows(shards, range(start, start + n), x.device, axis))
        start += n
    return out


def reshard_hw(grid, heights: Sequence[int], widths: Sequence[int]) -> list:
    """A grid of tiles cut again into tiles of ``heights`` rows and
    ``widths`` columns: each tile row along W, then each tile column along
    H."""
    wide = [reshard_rows(row, widths, axis=2) for row in grid]
    return columns([reshard_rows(col, heights) for col in columns(wide)])


def halo_slabs(shards, r: int, pad: str = "reflect", axis: int = 1) -> list:
    """Each shard with its ``r`` halo rows above and below: (B, h + 2r, W,
    C) (``axis`` 2: each W-tile with its ``r`` columns left and right). A
    grid of tiles: each tile with ``r`` halo rows and columns on every side
    and the corners, (B, h + 2r, w + 2r, C): each tile row's columns along
    W first, then each tile column's rows along H over the W-grown tiles."""
    if tiled(shards):
        wide = [halo_slabs(row, r, pad, axis=2) for row in shards]
        return columns([halo_slabs(col, r, pad) for col in columns(wide)])
    return [torch.cat([top, x, bot], dim=axis)
            for x, (top, bot) in zip(shards, exchange_halo_rows(shards, r, pad, axis))]


def _reduce(ts: Sequence[torch.Tensor], op) -> list[torch.Tensor]:
    dev = ts[0].device
    acc = ts[0]
    for t in ts[1:]:
        acc = op(acc, t.to(dev))
    return [acc if t.device == dev else acc.to(t.device) for t in ts]


def all_sum(ts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards' tensors, added in shard order on shard 0's
    device, one copy back on each shard's device (a grid's tiles: their
    tensors as a list in ``tiles`` order)."""
    return _reduce(ts, torch.add)


def all_max(ts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``all_sum`` with the elementwise maximum."""
    return _reduce(ts, torch.maximum)


def on_shards(fn, *xs):
    """``fn`` applied shard by shard to images held as lists of H-shards
    (tile by tile to grids of tiles), or once to whole tensors."""
    if sharded(xs[0]):
        return [on_shards(fn, *parts) for parts in zip(*xs)]
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
    (a grid's tiles') sums added in shard (tile) order over the whole image's count (an empty shard
    adds nothing), on shard 0's device; of a tensor ``x.mean()``."""
    if not sharded(x):
        return x.mean()
    return global_sum([s.sum() for s in tiles(x)]) / sum(s.numel() for s in tiles(x))


def check_spatial_compat(module, mesh: Sequence) -> None:
    """Raise where ``module`` would miscompute under the spatial mesh
    (``spatial.py:86-134``): the norm-blur tail and the 7×7 head kernels
    reflect at the image's edges and have no spatial form, so they must be
    off; on a 2-D mesh (rows of devices) the fused blocks, whose halo forms
    take rows only, must be off too, as JAX's runner turns them off there;
    the generator's ``spatial_mesh`` must be this mesh."""
    if getattr(module, "pallas_norm_blur", False) or getattr(module, "pallas_head", False):
        raise ValueError(
            "spatial sharding with pallas_norm_blur=True or pallas_head=True produces "
            "wrong shard-seam pixels (the kernels reflect at the shard's own edges) — "
            "rebuild the generator with both False (the test runner does this)"
        )
    if tiled(mesh) and any(getattr(b, "pallas_block", False)
                           for b in getattr(module, "resblocks", ())):
        raise ValueError(
            "2-D H×W spatial tiling with pallas_block=True: the fused blocks' halo forms "
            "exchange rows only — rebuild the generator with pallas_block=False (the test "
            "runner does this)"
        )
    sp = getattr(module, "spatial_mesh", None)
    if sp is not None and list(sp) != list(mesh):
        raise ValueError("the generator's spatial_mesh is not this mesh")
