"""Host input pipeline (``ircolor_tpu/data/pipeline.py``): thread-pool
decode (cv2 releases the GIL) with a bounded prefetch queue, yielding
stacked NHWC numpy batches.

The epoch shuffle is ``random.Random(seed·100003 + epoch)``. ``transport``
``"int"`` yields uint16 IR + uint8 RGB (a third of the float bytes; the
train step decodes them), ``"float"`` float32 in [−1, 1], assembled by the
native C++ assembler (``data.native``) from the frames' uint8 pixels where
every frame of the batch is 8-bit (``use_native``). Data parallelism:
``shard_index`` / ``shard_count`` give a rank its contiguous slice of every
global batch (``batch_size`` stays global).
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

from ircolor_tpu_torch.data import native
from ircolor_tpu_torch.data.kaist import KAISTPairDataset


def _stack(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {"ir": np.stack([s["ir"] for s in samples]), "rgb": np.stack([s["rgb"] for s in samples])}


def _assemble_native(raw: list, nthreads: int) -> dict[str, np.ndarray]:
    """The C++ normalize + flip + stack of ``raw_item`` outputs."""
    flips = [r[2] for r in raw]
    return {
        "ir": native.assemble_batch([r[0] for r in raw], flips, nthreads=nthreads),
        "rgb": native.assemble_batch([r[1] for r in raw], flips, nthreads=nthreads),
    }


class BatchLoader:
    """Iterable over stacked NHWC batches with background decode + prefetch
    (``shuffle``, ``drop_last`` and ``num_workers`` as in a torch
    DataLoader). With ``shard_count`` > 1 it yields rank ``shard_index``'s
    contiguous slice of each global batch of ``batch_size``. ``use_native``
    (float transport only; dropped under ``"int"``, as in JAX) builds the
    native assembler here and raises if it cannot."""

    def __init__(
        self,
        dataset: KAISTPairDataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        use_native: bool = True,
        transport: str = "float",
    ) -> None:
        if batch_size % shard_count != 0:
            raise ValueError("global batch_size must divide by shard_count")
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} outside [0, {shard_count})")
        if transport not in ("float", "int"):
            raise ValueError(f"transport must be 'float' or 'int', got {transport!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.transport = transport
        self._epoch = 0
        # The integer transport stacks integer arrays; the assembler writes
        # float32 only.
        self.use_native = use_native and transport == "float"
        if self.use_native:
            native.get_lib()

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.dataset.set_epoch(epoch)

    def _batch_indices(self) -> list[list[int]]:
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed * 100003 + self._epoch).shuffle(idxs)
        batches = [idxs[i : i + self.batch_size] for i in range(0, len(idxs), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.shard_count > 1:
            # Every rank yields as many batches as the others, since ranks
            # run their collectives in lockstep: a short final batch of r
            # rows is split evenly (rank k: rows [k·r/S, (k+1)·r/S)), and a
            # rank's slice may have 0 rows. The ranks' slices, concatenated,
            # are the global batch.
            per = self.batch_size // self.shard_count
            k, s = self.shard_index, self.shard_count
            batches = [b[k * per:(k + 1) * per] if len(b) == self.batch_size
                       else b[k * len(b) // s:(k + 1) * len(b) // s] for b in batches]
        return batches

    def _empty_batch(self) -> dict[str, np.ndarray]:
        """A 0-row batch of the right trailing shape and dtype."""
        h, w = self.dataset.size_hw
        if self.transport == "int":
            return {"ir": np.zeros((0, h, w, 1), np.uint16), "rgb": np.zeros((0, h, w, 3), np.uint8)}
        return {"ir": np.zeros((0, h, w, 1), np.float32), "rgb": np.zeros((0, h, w, 3), np.float32)}

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        batches = self._batch_indices()
        item = self.dataset.int_item if self.transport == "int" else self.dataset.__getitem__
        out_q: "queue.Queue[Any]" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        if not b:
                            out_q.put(self._empty_batch())
                            continue
                        if self.use_native:
                            raw = list(pool.map(self.dataset.raw_item, b))
                            if all(r is not None for r in raw):
                                out_q.put(_assemble_native(raw, self.num_workers))
                                continue
                        out_q.put(_stack(list(pool.map(item, b))))
                out_q.put(None)
            except Exception as exc:  # surfaced to the consumer, which re-raises
                out_q.put(exc)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                got = out_q.get()
                if got is None:
                    return
                if isinstance(got, Exception):
                    raise got
                yield got
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on put()
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
