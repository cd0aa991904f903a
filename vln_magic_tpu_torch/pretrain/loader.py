"""Task-mixing loader.

Port of ``vln_magic_tpu/pretrain/loader.py``.  ``MetaLoader`` and
``ItemSampler`` are copies (numpy only), so the same seed draws the same
task sequence and item order as JAX's.  The reference's MetaLoader samples
the next proxy task from a multinomial over per-task sampling ratios and
broadcasts the choice over ranks (reference: pretrain_src/data/loader.py:
18-88); every process here draws from the same seeded generator instead.
``PrefetchLoader`` moves each batch to the device one batch ahead.
"""

from __future__ import annotations

import numpy as np
import torch


class MetaLoader:
    """Round-robin-free multinomial task sampler over named batch factories."""

    def __init__(self, tasks: dict, ratios: dict | None = None, seed: int = 0,
                 accum_steps: int = 1):
        """``tasks``: name -> callable(batch_size) -> batch dict.
        ``accum_steps``: hold the sampled task for k consecutive batches so
        gradient accumulation windows stay single-task (the reference's
        ``self.step % self.accum_steps == 0`` redraw, loader.py:53-60)."""
        self.names = list(tasks)
        self.tasks = tasks
        r = np.array([float((ratios or {}).get(n, 1.0)) for n in self.names])
        self.p = r / r.sum()
        self.rng = np.random.default_rng(seed)
        self.accum_steps = max(int(accum_steps), 1)
        self._step = 0
        self._task = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._step % self.accum_steps == 0:
            self._task = self.rng.choice(self.names, p=self.p)
        self._step += 1
        return self._task, self.tasks[self._task]()

    def sample_sequence(self, n):
        return [self.rng.choice(self.names, p=self.p) for _ in range(n)]


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``.  On CUDA each array goes
    through pinned host memory and is copied with ``non_blocking=True``, so
    the copy overlaps whatever the device is running."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class PrefetchLoader:
    """Host-to-device overlap: while the device runs step N, the host
    assembles batch N+1 and starts its copy (the reference's
    PrefetchLoader, pretrain_src/data/loader.py:90-126).  Yields
    ``(task, batch of tensors on device)``."""

    def __init__(self, batch_iter, device, depth: int = 2):
        self.it = iter(batch_iter)
        self.device = torch.device(device)
        self.depth = depth
        self.queue = []

    def _put(self):
        try:
            name, batch = next(self.it)
        except StopIteration:
            return False
        self.queue.append((name, batch_to_device(batch, self.device)))
        return True

    def __iter__(self):
        while len(self.queue) < self.depth and self._put():
            pass
        while self.queue:
            item = self.queue.pop(0)
            self._put()
            yield item


class ItemSampler:
    """Epoch-shuffled minibatch cycler over an item list."""

    def __init__(self, items, batch_size: int, seed: int = 0):
        self.items = items
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(len(items))
        self.pos = 0

    def next_batch(self):
        if self.pos + self.bs > len(self.order):
            self.order = self.rng.permutation(len(self.items))
            self.pos = 0
        idx = self.order[self.pos : self.pos + self.bs]
        self.pos += self.bs
        return [self.items[i] for i in idx]
