"""vln_magic_tpu_torch.parallel without a process group (or with a
one-process one): the split decision of every leaf by flax name equals
JAX's ``shard_params`` (``param_spec`` plus divisibility) for
tests/test_multichip.py's student and teacher; ``make_mesh``'s errors;
``batch_spec`` and ``shard_batch``'s rows against JAX's; BMUF against
JAX's functions, the fairseq recurrence and local SGD converging."""

import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from vln_magic_tpu.parallel import bmuf as jbmuf
from vln_magic_tpu.parallel import sharding as jshard
from vln_magic_tpu_torch import parallel as P
from vln_magic_tpu_torch.parallel import bmuf as tbmuf
from vln_magic_tpu_torch.parallel import sharding as tshard
from vln_magic_tpu_torch.utils.weights import export_flax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nested(flat: dict) -> dict:
    tree = {}
    for name, arr in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


@pytest.fixture(scope="module")
def models():
    from vln_magic_tpu_torch.agent.trainer import Trainer

    cfg, world, _ = W.setup()
    tr = Trainer(cfg, world, device="cpu")
    return {"student": tr.model, "teacher": tr.teacher_model}


@pytest.mark.parametrize("role", ["student", "teacher"])
@pytest.mark.parametrize("mp", [2, 4])
def test_split_decision_matches_jax(models, role, mp):
    """Every leaf's split axis (flax layout) is the one JAX's
    ``shard_params`` gives it on a dp x mp mesh of the conftest's CPU
    devices, and at mp 2 some leaf splits."""
    flat = export_flax_params(models[role])
    devs = np.array(jax.devices()[:8]).reshape(8 // mp, mp)
    sharded = jshard.shard_params(_nested(flat), JaxMesh(devs, ("dp", "mp")))
    jax_axis = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(sharded):
        name = ".".join(p.key for p in path)
        spec = tuple(leaf.sharding.spec)
        jax_axis[name] = spec.index("mp") if "mp" in spec else None
        assert tshard.param_spec(name, leaf.ndim) == tuple(
            jshard.param_spec(path, leaf)), name
    port_axis = {name: tshard.split_axis(name, arr.shape, mp)
                 for name, arr in flat.items()}
    assert port_axis == jax_axis
    split = {k for k, v in port_axis.items() if v is not None}
    assert "params.lang_encoder.word_embeddings.embedding" in split
    assert any(k.endswith("attention.query.kernel") for k in split)
    assert any(k.endswith("ffn.output.kernel") for k in split)
    # the module view (torch axes) names the same leaves
    mods = tshard._module_splits(models[role], mp)
    assert {name for name, _ in mods.values()} == split


def test_param_spec_rules():
    spec = tshard.param_spec
    assert spec("params.a.query.kernel", 2) == (None, "mp")
    assert spec("params/a/z_proj/kernel", 2) == (None, "mp")
    assert spec("params.a.output.kernel", 2) == ("mp", None)
    assert spec("params.a.query.bias", 1) == ()
    assert spec("params.lang_encoder.word_embeddings.embedding", 2) == \
        ("mp", None)
    assert spec("params.a.dense.kernel", 2) == ()
    assert tshard.split_axis("params.a.query.kernel", (4, 6), 4) is None
    assert tshard.split_axis("params.a.query.kernel", (4, 8), 4) == 1
    assert tshard.split_axis("params.a.query.kernel", (4, 8), 1) is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_make_mesh_errors():
    """No group: RuntimeError; a world of 1: ``ValueError`` for mp 2 (not
    divisible, JAX's message) and for 2 devices; a 1 x 1 mesh otherwise,
    whose collectives are the identity."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        P.make_mesh()
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1,
        rank=0)
    try:
        with pytest.raises(ValueError, match="not divisible by mp=2"):
            P.make_mesh(mp=2, device="cpu")
        with pytest.raises(ValueError, match="2 devices"):
            P.make_mesh(2, device="cpu")
        mesh = P.make_mesh(device="cpu")
        assert mesh.shape == {"dp": 1, "mp": 1}
        assert (mesh.dp_rank, mesh.mp_rank, mesh.backend) == (0, 0, "gloo")
        assert mesh.dp_group is None and mesh.mp_group is None
        x = torch.arange(6.0).reshape(2, 3)
        assert tshard.gather_from_mp(x, mesh) is x
        assert P.shard_batch(x, mesh) is not None
        assert torch.equal(P.shard_batch(x, mesh), x)
    finally:
        torch.distributed.destroy_process_group()


def _fake_mesh(dp, dp_rank):
    mesh = P.Mesh.__new__(P.Mesh)
    mesh.dp, mesh.dp_rank = dp, dp_rank
    return mesh


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_shard_batch_rows(dp):
    """Each dp rank's rows are JAX's contiguous 'dp' shard of the batch
    axis, for tensors, arrays, lists and an episode-state tree."""
    x = np.arange(8 * 3).reshape(8, 3)
    assert tshard.batch_spec(x) == tuple(jshard.batch_spec(x))
    assert tshard.batch_spec(np.float32(1)) == tuple(
        jshard.batch_spec(np.float32(1)))
    devs = np.array(jax.devices()[:dp]).reshape(dp, 1)
    jx = jshard.shard_batch(jnp.asarray(x), JaxMesh(devs, ("dp", "mp")))
    shards = sorted(jx.addressable_shards, key=lambda s: s.index[0].start)
    tree = {"a": torch.from_numpy(x), "b": list(range(8)), "c": None}
    for r, shard in enumerate(shards):
        mesh = _fake_mesh(dp, r)
        np.testing.assert_array_equal(tshard.shard_batch(x, mesh),
                                      np.asarray(shard.data))
        got = tshard.shard_pytree_batch(tree, mesh)
        np.testing.assert_array_equal(got["a"].numpy(),
                                      np.asarray(shard.data))
        assert got["c"] is None
        assert got["b"] == list(range(8))[mesh.rows(8)]
    with pytest.raises(ValueError, match="divisible"):
        _fake_mesh(3, 0).rows(8)


def test_replicate_puts_a_tree_on_the_rank_device():
    """``replicate``: every tensor of a tree (dicts, tuples, dataclasses)
    on the mesh's device, other leaves as they were."""
    import dataclasses

    @dataclasses.dataclass
    class Tables:
        dist: torch.Tensor
        name: str

    mesh = _fake_mesh(1, 0)
    mesh.device = torch.device("cpu")
    tree = {"t": Tables(torch.ones(2, dtype=torch.float64), "w"),
            "pair": (torch.zeros(1), 3)}
    got = tshard.replicate(tree, mesh)
    assert got["t"].name == "w" and got["pair"][1] == 3
    assert torch.equal(got["t"].dist, tree["t"].dist)
    assert got["pair"][0].device == mesh.device


def test_bmuf_matches_jax_and_recurrence():
    """One sync equals JAX's and fairseq's recurrence: v' = bm*v +
    (1-bm)*lr*(avg - global), global' = global + v', workers restart from
    global' + bm*v' (Nesterov) or global' (without)."""
    g = {"w": np.asarray([1.0, 2.0], np.float32),
         "b": np.asarray([[0.5]], np.float32)}
    drift = {"w": np.asarray([[0.4, 0.0], [0.0, 0.4], [0.2, 0.2],
                              [0.2, 0.2]], np.float32),
             "b": np.asarray([[[0.1]], [[0.2]], [[0.3]], [[-0.2]]],
                             np.float32)}
    for nesterov in (True, False):
        j_state, t_state = jbmuf.bmuf_init(g), tbmuf.bmuf_init(g)
        j_w = {k: v + drift[k] for k, v in
               jbmuf.replicate_workers(g, 4).items()}
        t_w = {k: v + torch.from_numpy(drift[k]) for k, v in
               tbmuf.replicate_workers(g, 4).items()}
        for _ in range(3):
            j_w, j_state = jbmuf.bmuf_sync(j_w, j_state, 0.5, 0.8, nesterov)
            t_w, t_state = tbmuf.bmuf_sync(t_w, t_state, 0.5, 0.8, nesterov)
        for k in g:
            np.testing.assert_allclose(t_w[k].numpy(), np.asarray(j_w[k]),
                                       rtol=1e-6, atol=1e-7)
            for part in ("global", "velocity"):
                np.testing.assert_allclose(
                    t_state[part][k].numpy(), np.asarray(j_state[part][k]),
                    rtol=1e-6, atol=1e-7)
    state = tbmuf.bmuf_init({"w": torch.tensor([1.0, 2.0])})
    workers = {"w": tbmuf.replicate_workers(
        {"w": torch.tensor([1.0, 2.0])}, 4)["w"]
        + torch.from_numpy(drift["w"])}
    new, state = tbmuf.bmuf_sync(workers, state, block_momentum=0.5)
    v = 0.5 * (np.asarray([1.2, 2.2]) - np.asarray([1.0, 2.0]))
    np.testing.assert_allclose(state["global"]["w"].numpy(),
                               np.asarray([1.0, 2.0]) + v, rtol=1e-6)
    for w in range(4):
        np.testing.assert_allclose(new["w"][w].numpy(),
                                   np.asarray([1.0, 2.0]) + 1.5 * v,
                                   rtol=1e-6)


def test_bmuf_local_sgd_converges():
    """Four workers on their own quadratics, synced every 5 steps,
    converge to the joint optimum."""
    targets = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32))
    state = tbmuf.bmuf_init({"w": torch.zeros(8)})
    workers = tbmuf.replicate_workers({"w": torch.zeros(8)}, 4)
    for step in range(150):
        workers = {"w": workers["w"] - 0.1 * 2 * (workers["w"] - targets)}
        if (step + 1) % 5 == 0:
            workers, state = tbmuf.bmuf_sync(workers, state,
                                             block_momentum=0.5)
    assert float((state["global"]["w"] - targets.mean(0)).abs().max()) < 0.01
