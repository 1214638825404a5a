"""Batch pipeline: dataset -> device-ready dict batches.

Replaces the reference's torch DataLoader (bs=4, 2 workers, persistent;
reference model/CE/createViTmodel.py:57-59). Batches are stacked numpy dicts;
sharded device placement happens in the Trainer via NamedSharding — the only
host work per batch is image decode + stacking (the mask remap is a LUT take
and SDFs moved on-device, see data/dataset.py).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = False,
                   seed: int = 0, epoch: int = 0,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Yield {'image': (B,H,W,3) f32, 'mask': (B,...)} batches.

    drop_last=True keeps shapes static across steps — one XLA program, no
    recompiles (ragged final batches are the classic jit trap).
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)

    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        images, masks = zip(*(dataset[int(i)] for i in idx))
        yield {"image": np.stack(images), "mask": np.stack(masks)}


def num_batches(dataset, batch_size: int, drop_last: bool = True) -> int:
    n = len(dataset)
    return n // batch_size if drop_last else -(-n // batch_size)


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so host
    image decode overlaps device compute (the role of the reference's
    num_workers=2 DataLoader processes, reference model/CE/createViTmodel.py:57)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as exc:  # propagate into the consumer thread
            q.put((sentinel, exc))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
            raise item[1]
        yield item
