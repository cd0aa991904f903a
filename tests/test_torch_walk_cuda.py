"""The observed-subgraph walk's kernel (``csrc/observed_walk.cu``, wrapper
``ops.walk.observed_walk``) on the card, held exactly to the torch loop
(``Rollout._walk_loop``) and to the NumPy reference, and the serving paths
that take it.

These tests need an NVIDIA GPU and the CUDA toolkit (``nvcc``); elsewhere
they skip.  They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_walk_cuda.py

The graphs are tests/torch_walk_cases.py's, as on the CPU
(tests/test_torch_walk.py).  Every comparison is exact: the walk is integer
indexing, one f32 add and compares.
"""

import pytest
import torch

import torch_walk_cases as W
from test_torch_fleet import build_setup, fleet, fleet_equals_standalone
from vln_magic_tpu_torch.ops import walk

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(case, dev):
    tables, state, *rest = case
    return (W.to(tables, dev), W.to(state, dev),
            *(x.to(dev) if torch.is_tensor(x) else x for x in rest))


def launched(fn, *args):
    """(fn(*args) on the host, the walk kernel's launches during it)."""
    n0 = walk.observed_walk.launches
    out = fn(*args)
    torch.cuda.synchronize()
    return tuple(x.cpu() for x in out), walk.observed_walk.launches - n0


def assert_equal(got, want, what):
    for name, g, w in zip(("prev", "ln", "nodes"), got, want):
        assert torch.equal(g, w), (name, what)


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("seed,c", W.GRAPHS)
def test_kernel_equals_loop_and_reference(cuda, seed, c, b):
    """One launch per walk, equal to the CPU loop and the reference."""
    case = W.make_case(seed, b, c)
    got, n = launched(W.rollout_walk, *on(case, cuda))
    assert n == 1
    assert_equal(got, W.rollout_walk(*case), "loop")
    assert_equal(got, W.reference_walk(*case), "reference")


@pytest.mark.parametrize("seed", [1, 6])
def test_kernel_equals_the_loop_on_the_card(cuda, seed):
    """The kernel against the torch loop run on the same card tensors."""
    case = on(W.make_case(seed, 64, 16), cuda)
    got, n = launched(W.rollout_walk, *case)
    loop, n_loop = launched(W.loop_walk, *case)
    assert (n, n_loop) == (1, 0)
    assert_equal(got, loop, "loop on the card")


def test_strided_inputs(cuda):
    """Views read in place: candidate tables cut from one packed buffer
    (the fleet's upload), visited and nodes as column slices, an expanded
    obs_dist (stride 0), a strided target."""
    tables, state, target, moving, nodes, ln, hops = W.make_case(5, 64, 16)
    state.obs_dist = state.obs_dist[:1].expand_as(state.obs_dist)
    want = W.reference_walk(tables, state, target, moving, nodes, ln, hops)
    s, n, c = tables.cand_ids.shape
    packed = torch.cat([tables.cand_ids.float().reshape(s, -1),
                        tables.cand_dist.reshape(s, -1),
                        torch.zeros(s, 7)], 1).to(cuda)
    dt = W.to(tables, cuda)
    dt.cand_dist = packed[:, n * c:2 * n * c].reshape(s, n, c)
    ds = W.to(state, cuda)
    ds.obs_dist = state.obs_dist[:1].to(cuda).expand(64, n, n)
    ds.visited = torch.cat([state.visited, state.visited], 1).to(cuda)[
        :, :n + 1]
    wide = torch.cat([nodes, nodes], 1).to(cuda)
    out = wide[:, :nodes.shape[1]]
    assert not (dt.cand_dist.is_contiguous() or out.is_contiguous()
                or ds.visited.is_contiguous())
    tgt = torch.stack([target, target], 1).to(cuda)[:, 0]
    prev, new_ln = walk.observed_walk(
        dt.cand_ids, dt.cand_mask, dt.cand_dist, ds.scan, ds.cur, tgt,
        moving.to(cuda), ds.visited, ds.obs_dist, out, ln.to(cuda), hops)
    assert_equal((prev.cpu(), new_ln.cpu(), out.cpu()), want, "strided")
    assert torch.equal(wide[:, nodes.shape[1]:].cpu(), nodes)


@pytest.mark.parametrize("seed", [0, 1])
def test_wide_candidate_tables_take_the_kernel(cuda, seed):
    """40 candidate slots, wider than a warp: one launch, equal to the
    reference and to the loop on the card."""
    case = W.make_case(seed, 64, **W.WIDE)
    got, n = launched(W.rollout_walk, *on(case, cuda))
    assert n == 1
    assert_equal(got, W.reference_walk(*case), "C 40 reference")
    loop, _ = launched(W.loop_walk, *on(case, cuda))
    assert_equal(got, loop, "C 40 loop on the card")


def test_fleet_equals_standalone_sessions_on_the_card(cuda):
    """tests/test_torch_fleet.py's six episodes on the card: a fleet of 4
    against standalone sessions, decisions, stops and ``finish()``
    trajectories equal; the fleet launches the walk once a tick and once a
    finish."""
    s = build_setup("cuda")
    f = fleet(s, 4)
    f.warmup()
    n0 = walk.observed_walk.launches
    ticks, finishes = fleet_equals_standalone(s, f)
    assert walk.observed_walk.launches - n0 == ticks + finishes
