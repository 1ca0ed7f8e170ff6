"""Host input pipeline (``ircolor_tpu/data/pipeline.py``, single process):
thread-pool decode (cv2 releases the GIL) with a bounded prefetch queue,
yielding stacked NHWC numpy batches.

The epoch shuffle is ``random.Random(seed·100003 + epoch)``. ``transport``
``"int"`` yields uint16 IR + uint8 RGB (a third of the float bytes; the
train step decodes them), ``"float"`` float32 in [−1, 1]. The native C++
batch assembler of the JAX package is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np

from ircolor_tpu_torch.data.kaist import KAISTPairDataset


def _stack(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    return {"ir": np.stack([s["ir"] for s in samples]), "rgb": np.stack([s["rgb"] for s in samples])}


class BatchLoader:
    """Iterable over stacked NHWC batches with background decode + prefetch
    (``shuffle``, ``drop_last`` and ``num_workers`` as in a torch
    DataLoader)."""

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
        transport: str = "float",
    ) -> None:
        if transport not in ("float", "int"):
            raise ValueError(f"transport must be 'float' or 'int', got {transport!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.transport = transport
        self._epoch = 0

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
        return batches

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
