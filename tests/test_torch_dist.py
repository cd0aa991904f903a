"""The port's multi-process helpers (vln_magic_tpu_torch.utils.dist) held
against vln_magic_tpu.utils.dist: contiguous evaluation shards and the
prediction merge equal JAX's, one process passes everything through, and
two gloo processes on the CPU gather each other's predictions."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vln_magic_tpu.utils import dist as jdist
from vln_magic_tpu_torch.utils import dist as tdist


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n_items,n_shards", [(10, 1), (10, 3), (7, 4),
                                              (2, 4), (0, 2)])
def test_shard_items_matches_jax(n_items, n_shards):
    items = list(range(n_items))
    shards = [tdist.shard_items(items, n_shards, i) for i in range(n_shards)]
    assert shards == [jdist.shard_items(items, n_shards, i)
                      for i in range(n_shards)]
    assert sum(shards, []) == items


def test_merge_matches_jax():
    lists = [[{"instr_id": "1_0"}, {"instr_id": "1_1"}],
             [{"instr_id": "1_1", "other": True}, {"instr_id": "2_0"}],
             []]
    got = tdist.merge_dist_results(lists)
    assert got == jdist.merge_dist_results(lists)
    assert [p["instr_id"] for p in got] == ["1_0", "1_1", "2_0"]
    assert "other" not in got[1]


def test_one_process_passes_through():
    preds = [{"instr_id": "3_0", "trajectory": [["a"]]}]
    assert tdist.process_count() == jdist.process_count() == 1
    assert tdist.is_primary() and jdist.is_primary()
    assert tdist.gather_predictions(preds) is preds
    x = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(tdist.all_gather_arrays(x),
                                  jdist.all_gather_arrays(x))
    items = list(range(9))
    assert tdist.shard_items(items) == jdist.shard_items(items) == items


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# one rank of the two-process run, in a fresh interpreter that imports
# torch and the port only
GLOO_WORKER = """
import json, os, sys
import numpy as np
import torch
from vln_magic_tpu_torch.utils import dist as tdist

rank, world, port, out_dir = int(sys.argv[1]), 2, sys.argv[2], sys.argv[3]
torch.distributed.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
    rank=rank)
try:
    items = [f"{k}_0" for k in range(7)]
    mine = tdist.shard_items(items)
    # rank 1 repeats rank 0's last item: the merge keeps one
    preds = [{"instr_id": i, "rank": rank} for i in mine]
    if rank == 1:
        preds.insert(0, {"instr_id": items[2], "rank": rank})
    gathered = tdist.gather_predictions(preds)
    arrays = tdist.all_gather_arrays(np.full(3, rank, np.int64))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"shard": mine, "gathered": gathered,
                   "arrays": arrays.tolist(),
                   "primary": tdist.is_primary(),
                   "count": tdist.process_count()}, f)
finally:
    torch.distributed.destroy_process_group()
"""


def test_two_gloo_processes_gather_predictions(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_WORKER, str(r),
                               port, str(tmp_path)], env=env)
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0, 0]
    out = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert [o["shard"] for o in out] == [["0_0", "1_0", "2_0"],
                                         ["3_0", "4_0", "5_0", "6_0"]]
    want = jdist.merge_dist_results(
        [[{"instr_id": i, "rank": r} for i in o["shard"]]
         for r, o in enumerate(out)])
    for o in out:
        assert o["gathered"] == want
        assert o["arrays"] == [[0, 0, 0], [1, 1, 1]]
        assert o["count"] == 2
    assert [o["primary"] for o in out] == [True, False]
