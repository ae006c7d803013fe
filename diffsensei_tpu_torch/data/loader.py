"""Host-side prefetch feeding the device (port of
``diffsensei_tpu/data/loader.py``).

``MangaTrainSizeBucketDataset.batches(num_workers=N)`` builds each batch's
samples on a thread pool; ``PrefetchLoader`` runs one producer thread that
drains that iterator through a bounded queue and puts every batch on the
device ahead of the train step: numpy arrays become pinned host tensors
copied with ``non_blocking``, so the copy overlaps the step before it. Unlike
the JAX loader, an error in the producer is raised in the consumer, not
swallowed as the end of the stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from diffsensei_tpu_torch.utils.observability import span


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: pinned, asynchronous copies to
    a card, plain tensors on the CPU."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class PrefetchLoader:
    """Wrap a batch-iterator factory ``epoch -> iterator`` with background
    prefetch and the device put; epochs run from ``first_epoch`` on, until
    ``num_epochs`` of them have run (None: forever)."""

    def __init__(self, batch_factory: Callable[[int], Iterator[Dict[str, np.ndarray]]],
                 device="cuda", num_epochs: Optional[int] = None, prefetch: int = 2,
                 first_epoch: int = 0):
        self.batch_factory = batch_factory
        self.device = torch.device(device)
        self.num_epochs = num_epochs
        self.prefetch = prefetch
        self.first_epoch = first_epoch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            epoch = self.first_epoch
            try:
                while self.num_epochs is None or epoch < self.first_epoch + self.num_epochs:
                    for batch in self.batch_factory(epoch):
                        with span("data.put"):
                            batch = to_device(batch, self.device)
                        if not put(batch):
                            return
                    epoch += 1
                put(end)
            except Exception as e:           # the consumer raises it
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                with span("data.wait"):
                    item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
