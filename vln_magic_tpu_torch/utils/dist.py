"""Multi-process coordination: result gathering and evaluation shards.

Port of ``vln_magic_tpu/utils/dist.py`` on ``torch.distributed``.  The
reference gathers pickled prediction lists over NCCL and merges them
(reference: map_nav_src/utils/distributed.py:90-160); here predictions go
through ``all_gather_object`` and are de-duplicated by ``instr_id``.

Without an initialised process group the program is one process and
everything passes through untouched, as JAX's does at
``process_count() == 1``.  The caller initialises the group itself
(``torch.distributed.init_process_group`` with its address, world size and
rank).
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _group() else 1


def process_index() -> int:
    return dist.get_rank() if _group() else 0


def is_primary() -> bool:
    return process_index() == 0


def all_gather_arrays(x: np.ndarray) -> np.ndarray:
    """Gather a same-shape array from every process; [P, ...] result."""
    if process_count() == 1:
        return np.asarray(x)[None]
    out = [None] * process_count()
    dist.all_gather_object(out, np.asarray(x))
    return np.stack(out)


def merge_dist_results(per_process_preds: list[list]) -> list:
    """Flatten per-process prediction lists, deduplicating by instr_id
    (reference merge_dist_results, utils/distributed.py:160)."""
    seen = set()
    out = []
    for preds in per_process_preds:
        for p in preds:
            key = p.get("instr_id") if isinstance(p, dict) else id(p)
            if key in seen:
                continue
            seen.add(key)
            out.append(p)
    return out


def gather_predictions(preds: list[dict]) -> list[dict]:
    """Every process's predictions, merged in rank order (one process:
    ``preds`` as given)."""
    if process_count() == 1:
        return preds
    lists = [None] * process_count()
    dist.all_gather_object(lists, preds)
    return merge_dist_results(lists)


def shard_items(items: list, n_shards: int | None = None,
                shard_id: int | None = None) -> list:
    """Contiguous per-process eval slices (reference sel_data_idxs,
    env.py:126-134)."""
    n = n_shards or process_count()
    i = shard_id if shard_id is not None else process_index()
    per = len(items) // n
    start = per * i
    end = None if i == n - 1 else start + per
    return items[start:end]
