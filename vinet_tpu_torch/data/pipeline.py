"""Host loader and device-side preprocessing, ``vinet_tpu/data/pipeline.py``.

``Loader`` decodes items on a thread pool (PIL decode releases the GIL) into
a bounded prefetch queue and stacks them into numpy batches; normalisation
runs on the device (``device_preprocess``), so the host ships uint8.

Determinism, as the JAX package's: the batch order of an epoch comes from
``default_rng((seed, epoch))`` and item i's generator is
``default_rng((seed, epoch, i))``, with epoch already counted up for the
next epoch when the items are drawn; ``shard=(rank, world)`` slices the
index set per process.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vinet_tpu_torch.ops.image import normalize_imagenet


def device_preprocess(clip_u8: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> f32 / 255 -> ImageNet-normalised, on the
    tensor's own device (``vinet_tpu/data/pipeline.py::device_preprocess``)."""
    return normalize_imagenet(clip_u8.float() / 255.0)


def _stack(items: list) -> dict:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class Loader:
    def __init__(self, dataset, *, batch_size, shuffle=False, num_workers=4, seed=0,
                 drop_last=True, shard=(0, 1), prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        rank, world = self.shard
        n = len(range(rank, len(self.dataset), world))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        rank, world = self.shard
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(idx)
        idx = idx[rank::world]
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop, closed = object(), threading.Event()

        def put(item) -> bool:
            while not closed.is_set():  # the consumer may stop early
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in batches:
                        # self.epoch was counted up above: it defines the stream
                        seeds = [np.random.default_rng((self.seed, self.epoch, int(i)))
                                 for i in b]
                        if not put(_stack(list(pool.map(self.dataset.get, b, seeds)))):
                            return
            except Exception as e:  # re-raised by the consumer
                put(e)
            put(stop)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            closed.set()
            producer.join()
