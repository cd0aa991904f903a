"""The observed-subgraph walk on the CPU: the torch loop
(``Rollout._walk_loop``), which every CPU caller takes, held to
``ops.walk``'s NumPy reference, equal in prev, the trajectory lengths and
every entry of the trajectory.

Port only: no JAX program is compiled.  The graphs are
tests/torch_walk_cases.py's: eight seeded sets of scans at C 10 and 16, B 1
and B 64, with tied costs, unreachable targets, targets at the current
node, lanes that do not move, and full trajectory buffers; and two of 40
candidate slots, wider than a warp.
"""

import numpy as np
import pytest
import torch

import torch_walk_cases as W
from vln_magic_tpu_torch.agent.rollout import MAX_TRAJ
from vln_magic_tpu_torch.ops import walk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("seed,c", W.GRAPHS)
def test_loop_equals_reference(seed, c, b):
    case = W.make_case(seed, b, c)
    loop = W.rollout_walk(*case)
    ref = W.reference_walk(*case)
    for name, got, want in zip(("prev", "ln", "nodes"), loop, ref):
        assert torch.equal(got, want), (name, seed, c, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_wide_loop_equals_reference(seed):
    """Tables of 40 candidate slots, more than a warp has threads."""
    case = W.make_case(seed, 64, **W.WIDE)
    for name, got, want in zip(("prev", "ln", "nodes"), W.rollout_walk(*case),
                               W.reference_walk(*case)):
        assert torch.equal(got, want), (name, seed)


def first_hops(case):
    """Each moving lane's first hop, where it has one to choose: (lane,
    the slots of least cost among those it may step to)."""
    tables, state, target, moving, *_ = case
    for i in np.flatnonzero(moving.numpy()):
        p, t, s = int(state.cur[i]), int(target[i]), int(state.scan[i])
        if p == t:
            continue
        cand = tables.cand_ids[s, p].numpy()
        safe = np.maximum(cand, 0)
        ok = tables.cand_mask[s, p].numpy() & (
            state.visited[i].numpy()[safe] | (cand == t))
        cost = np.where(ok, tables.cand_dist[s, p].numpy()
                        + state.obs_dist[i, t].numpy()[safe], walk.INF_DIST)
        least = np.flatnonzero((cost == cost.min())
                               & (cost < walk.INF_DIST / 2))
        yield i, least


def test_cases_reach_every_edge():
    """Over the B 64 cases the walks meet what the tests are for: a first
    hop with tied least costs, a moving lane that finds no step, a lane at
    its target from the outset, walks to the hop bound, and hops written
    past the buffer's end."""
    seen = dict.fromkeys(("tie", "no_step", "at_target", "hop_bound",
                          "overflow"), False)
    for seed, c in W.GRAPHS:
        case = W.make_case(seed, 64, c)
        _, state, target, moving, _, ln, hops = case
        _, new_ln, _ = W.reference_walk(*case)
        for i in np.flatnonzero(moving.numpy()):
            steps = int(new_ln[i] - ln[i])
            at_target = int(state.cur[i]) == int(target[i])
            seen["at_target"] |= at_target
            seen["no_step"] |= not at_target and steps == 0
            seen["hop_bound"] |= steps == hops
            seen["overflow"] |= steps > 0 and int(new_ln[i]) > MAX_TRAJ + 1
        seen["tie"] |= any(len(least) > 1 for _, least in first_hops(case))
    assert all(seen.values()), seen


def test_wide_cases_reach_past_one_warp():
    """The wide cases' first hops take a slot past 31, and tie a slot
    below 32 with one past it: the kernel's per-thread scan and its
    reduction across the warp are both met."""
    least = [x for seed in (0, 1)
             for _, x in first_hops(W.make_case(seed, 64, **W.WIDE))]
    assert any(len(x) and x[0] >= 32 for x in least)
    assert any(len(x) and x[0] < 32 <= x[-1] for x in least)


def test_wrapper_on_cpu_is_the_reference():
    """``observed_walk`` on CPU tensors takes the plain version."""
    tables, state, target, moving, nodes, ln, hops = W.make_case(3, 64, 10)
    out = nodes.clone()
    prev, new_ln = walk.observed_walk(
        tables.cand_ids, tables.cand_mask, tables.cand_dist, state.scan,
        state.cur, target, moving, state.visited, state.obs_dist, out, ln,
        hops)
    ref = W.reference_walk(tables, state, target, moving, nodes, ln, hops)
    for got, want in zip((prev, new_ln, out), ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["no_slot", "dtype", "shape"])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    tables, state, target, moving, nodes, ln, hops = W.make_case(0, 4, 10)
    if bad == "no_slot":
        for k in ("cand_ids", "cand_mask", "cand_dist"):
            setattr(tables, k, getattr(tables, k)[..., :0])
    if bad == "dtype":
        target = target.int()
    if bad == "shape":
        state.obs_dist = state.obs_dist[:, :-1]
    with pytest.raises(ValueError):
        walk.observed_walk(tables.cand_ids, tables.cand_mask,
                           tables.cand_dist, state.scan, state.cur, target,
                           moving, state.visited, state.obs_dist, nodes, ln,
                           hops)
