"""The data-parallel input path against the JAX package's, on the CPU: the
rank-sharded ``BatchLoader`` (every rank's slices bit for bit, float and
integer transport, the native assembler on and off), the native batch
assembler (``data.native``: bit for bit, its refusals, a build that fails)
and ``raw_item`` (with the reference's max ≤ 1 frames)."""

import numpy as np
import pytest

from ircolor_tpu.data import kaist as jkaist
from ircolor_tpu.data import native as jnative
from ircolor_tpu.data.pipeline import BatchLoader as JBatchLoader

from ircolor_tpu_torch.data import kaist as tkaist
from ircolor_tpu_torch.data import native
from ircolor_tpu_torch.data.pipeline import BatchLoader
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# (transport, use_native): the assembler rounds its normalize an ulp away
# from the numpy path, so each side takes the same one; under "int" the
# native assembler is dropped on both sides.
_PATHS = (("float", True), ("float", False), ("int", True))


def _datasets(root, augment=True):
    roots = [str(root / "set00"), str(root / "set02")]
    ir, rgb = tkaist.scan_kaist_pairs(roots)
    return (tkaist.KAISTPairDataset(ir, rgb, size_hw=(32, 40), augment=augment, seed=5),
            jkaist.KAISTPairDataset(ir, rgb, size_hw=(32, 40), augment=augment, seed=5))


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shard_count", [1, 2, 3])
def test_sharded_loader_matches_jax(kaist_tree, shard_count, drop_last):
    """17 pairs in global batches of 6: two full batches and a final one of
    5 rows (drop_last=False), split 3/2, 2/2/1 ... over the ranks. Every
    rank yields the same number of batches, and each batch is JAX's bit for
    bit, dtype and all."""
    root, n = kaist_tree
    tds, jds = _datasets(root)
    for transport, use_native in _PATHS:
        per_rank = []
        for k in range(shard_count):
            kw = dict(shuffle=True, drop_last=drop_last, num_workers=2, seed=5, shard_index=k,
                      shard_count=shard_count, transport=transport, use_native=use_native)
            tl, jl = BatchLoader(tds, 6, **kw), JBatchLoader(jds, 6, **kw)
            tl.set_epoch(3)
            jl.set_epoch(3)
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == len(tl)
            for a, b in zip(got, want):
                for key in ("ir", "rgb"):
                    assert a[key].dtype == b[key].dtype, (transport, key)
                    np.testing.assert_array_equal(a[key], b[key])
            per_rank.append(got)
        rows = [sum(b["ir"].shape[0] for b in got) for got in per_rank]
        assert sum(rows) == (n // 6 * 6 if drop_last else n), rows


def test_assemble_batch_matches_jax():
    rng = np.random.RandomState(0)
    for shape in ((16, 20, 3), (8, 10, 1)):
        imgs = [rng.randint(0, 256, shape, np.uint8) for _ in range(5)]
        flips = [False, True, False, True, True]
        got = native.assemble_batch(imgs, flips, nthreads=3)
        np.testing.assert_array_equal(got, jnative.assemble_batch(imgs, flips, nthreads=3))
        out = np.empty((5, *shape), np.float32)
        assert native.assemble_batch(imgs, None, out=out, nthreads=2) is out
        np.testing.assert_array_equal(out, jnative.assemble_batch(imgs, None, nthreads=2))


def test_assemble_batch_refuses_what_it_cannot_write():
    """The C++ code strides every source by H·W·C and writes through a raw
    pointer: a wrong dtype, shape or ``out`` raises, as in JAX."""
    rng = np.random.RandomState(2)
    ok = [rng.randint(0, 256, (8, 10, 1), np.uint8) for _ in range(2)]
    with pytest.raises(TypeError, match="uint8"):
        native.assemble_batch([ok[0], ok[1].astype(np.uint16)])
    with pytest.raises(ValueError, match="expected"):
        native.assemble_batch([ok[0], rng.randint(0, 256, (8, 12, 1), np.uint8)])
    for bad in (np.empty((2, 8, 10, 1), np.float64), np.empty((3, 8, 10, 1), np.float32),
                np.empty((2, 8, 10, 2), np.float32)[..., :1]):
        with pytest.raises(ValueError, match="C-contiguous float32"):
            native.assemble_batch(ok, None, out=bad)


def test_failed_native_build_raises(tmp_path, monkeypatch, kaist_tree):
    """A source that does not compile raises with g++'s message, from the
    assembler and from a loader asked for it; ``use_native=False`` loads."""
    bad = tmp_path / "batchops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.assemble_batch([np.zeros((2, 2, 1), np.uint8)])
    tds, _ = _datasets(kaist_tree[0])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        BatchLoader(tds, 2)
    assert len(list(BatchLoader(tds, 2, drop_last=True, use_native=False))) == len(tds) // 2
    assert not list((tmp_path / "build").glob("*.so"))


def test_raw_item_matches_jax(tmp_path):
    """``raw_item`` is JAX's, None for the frames whose IR holds only 0s
    and 1s (the reference does not divide those by 255), and the native
    loader then takes the exact float path for their batch."""
    import cv2

    seq = tmp_path / "kq" / "set00" / "V000"
    (seq / "lwir").mkdir(parents=True)
    (seq / "visible").mkdir(parents=True)
    rng = np.random.RandomState(3)
    for i in range(4):
        hi = 2 if i % 2 == 0 else 256
        cv2.imwrite(str(seq / "lwir" / f"I{i:05d}.png"), rng.randint(0, hi, (32, 32), np.uint8))
        cv2.imwrite(str(seq / "visible" / f"I{i:05d}.png"),
                    rng.randint(0, 256, (32, 32, 3), np.uint8))
    ir, rgb = tkaist.scan_kaist_pairs([str(tmp_path / "kq" / "set00")])
    tds = tkaist.KAISTPairDataset(ir, rgb, size_hw=(32, 32), augment=True, seed=1)
    jds = jkaist.KAISTPairDataset(ir, rgb, size_hw=(32, 32), augment=True, seed=1)
    for i in range(4):
        got, want = tds.raw_item(i), jds.raw_item(i)
        assert (got is None) == (want is None) == (i % 2 == 0)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2]
    native_batches = list(BatchLoader(tds, 2, use_native=True))
    plain = list(BatchLoader(tds, 2, use_native=False))
    for a, b in zip(native_batches, plain):
        np.testing.assert_array_equal(a["ir"], b["ir"])
    assert max(float(b["ir"].max()) for b in plain) == 1.0
