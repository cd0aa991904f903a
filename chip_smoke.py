"""Smoke run of vln_magic_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. card and build: the card's name and power limit, the torch and CUDA
   versions, and the time to build the three CUDA kernels from
   vln_magic_tpu_torch/csrc/ with nvcc for sm_90a (one nvcc per source,
   started together), and ptxas' registers and spills of each instantiation
   of the fused kernel's tensor-core route;
2. packed kernel vs plain: ``packed_attention`` on the card against its
   plain PyTorch version at every shape of the main path (B 256, H 2,
   hd 64) and at edge shapes (the tensor-core route's fragment edges, and
   Lk 257, which takes the SIMT route), in f32 (2e-5 absolute) and bf16
   (5e-2 absolute), and against its own arithmetic, the plain version on
   the f32 upcast: out within one bf16 rounding of P and one of out
   (``attention.packed_attention_error``).  Each row names the route the
   call took and gives the kernel's time, its bound, the plain version's
   time and, as a yardstick only, ``scaled_dot_product_attention`` on the
   same inputs.  Every time in phases 2 and 7 is device time, from a CUDA
   graph of 20 calls (``time_ms``); the packed kernel's rows also give its
   time through the wrapper as a caller pays it (``eager_ms``); then the
   observed-subgraph walk's kernel (``ops.walk``) against the torch loop
   (``Rollout._walk_loop``) on the same card tensors, exactly, at the
   parity wave's transition and backtrack (B 256, 16 and 32 hops), the
   fleet's ticks (K 8, 64), a finish (B 1) and 40 candidate slots, one
   launch a walk, with both their times (``WALK_SHAPES``);
3. golden decodes: the pinned tests/golden_decode.json and
   tests/golden_decode_parity.json trajectories, in f32 with the kernel
   on (the SIMT route), from the weights in tests/fixtures/; and the same
   model streamed over 4 lanes, equal per episode to its wave decode;
4. main path: ``Navigator.evaluate`` on 256 items at MAGIC-S full width
   (hidden 128, 2 heads, 6/2/3 layers, CLIP-768 features, 200-token
   instructions, gmap 128, T 15, 3 scans x 320 nodes), bf16, random
   weights from a seed; the kernel must launch 216 times per wave, every
   launch on the tensor-core route, and the walk kernel never;
5. streaming: the same navigator streams 1,024 items over its 256 lanes;
   ``packed_attention`` must launch 6 times per language batch and 14 per
   step, all on the tensor-core route, and the share of episodes equal to
   the wave decode is reported;
6. parity: one wave of 256 items with observed-graph parity on, 216
   tensor-core launches and 16 of the walk kernel (15 transitions, one
   backtrack); a second wave's first transition and backtrack walks
   replayed on the torch loop, equal;
7. fused kernel vs plain: ``fused_attention`` against its plain version at
   the MAGIC-S and MAGIC teacher head layouts at the six path shapes and at
   edge shapes, in f32 and bf16, with its time, bound and plain time.  Out
   is held to the plain version on the same inputs (2e-5 f32, 5e-2 bf16);
   both outputs are also held to the kernel's own arithmetic, the plain
   version on the f32 upcast: the map to 2e-5, out within one bf16
   rounding of P and one of out (``attention.fused_attention_error``).
   Each row names the route the call took and gives its time through the
   wrapper (``eager_ms``); the bf16 rows also time the SIMT route on the
   same inputs, copied to a misaligned address (``simt_ms``).  Then its
   entry point once at each MAGIC-S shape, launches counted, every one on
   the tensor-core route, and a second call that must give the same bits;
8. training at full width: ``Trainer.train_step`` of the MAKD + ICoD DAgger
   step at ``bench.py --train``'s shape (MAGIC teacher hidden 768, 12
   heads, and the MAGIC-S student, 6/2/3 layers each; batch 16, bf16
   compute under autocast with f32 masters, AdamW at 4e-5, clip 40;
   teacher-forced then sampled rollouts of T 15 over gmap 128 and
   200-token instructions; all five abilities, MKTD, MKRW, the teacher
   co-trained), random weights from a seed: one warm-up step, three timed
   steps (synchronised ms each, every metric, peak memory), which must give
   finite metrics, ``grad_norm`` > 0, moved student and teacher
   parameters and no attention-kernel launch (the JAX train step runs no
   Pallas kernel); then one step with ``remat`` (its peak memory), and one
   under ``torch.profiler`` (device time, idle share, top 10 kernels), the
   dtype casts counted in the warm-up; a warm-up and one timed step with
   autocast's weight cache on, as before the repair (the repair's cost in
   casts and wall);
   then the training options on the same trainer, each one warm-up and
   one timed step (``OPTION_STEPS``) held to the same checks (ms, peak
   memory):
   ``grads_dtype="bfloat16"``, ``remat_policy`` ``dots`` and
   ``dots_all``, ``fuse_rollouts`` (and a profiled fused step: launches,
   idle share); one ``update_ability_grads`` on the 16 items; and one A2C
   step of a trainer with the teacher frozen (the student and the critic
   must move);
9. golden training step: ``tests/fixtures/golden_train_7.npz`` (a tiny JAX
   student, teacher and critic, the spec of its world, items and
   configuration, and JAX's ``compute_grads`` objective, per-partition
   gradient norms and some gradient leaves) through the port's
   ``compute_grads`` on the card in f32 with TF32 off: the objective to
   1e-5 relative, the norms and leaves to 1e-4; then the golden training
   options, ``tests/fixtures/golden_train_options_13.npz``
   (``golden_train_options``: the fused DAgger step with
   ``fusion='local'``, an aug batch and the ``grad`` ability weights, an
   A2C step, one ``update_ability_grads`` and seven steps of each new
   optimizer, weights from the seed) at the same tolerances, the
   optimizers to 1e-5;
10. serving (``agent/serving.py``): in f32 on the golden world and
    weights, every episode through a ``NavServer`` session and all of them
    through one ``NavFleet``, each equal to the offline parity wave, and a
    session saved mid-episode continuing identically on a fresh server and
    in a fleet slot; then at ``bench.py --serve``'s shape (MAGIC-S bf16,
    one 64-node scan): ``warmup()``, then episodes until 200 decisions are
    measured (the first episode left out), ms per decision and per session
    start, 6 ``packed_attention`` launches a session start and 14 a
    decision, all on the tensor-core route, and one walk launch a decision
    and one a finish; fleets of K 8 and 64 (rounds of K episodes until 200
    ticks are measured, round 0 left out), ms per tick and per decision, 14
    launches a tick and 6 more in a round's first tick, which encodes the
    round's K joins in one batch (a join encodes nothing), one walk launch
    a tick and one a finish, a decision's,
    a tick's and a finish's walks replayed on the torch loop, equal; the
    share of decisions equal to standalone sessions (bf16: reported); every ``packed_attention`` call
    of a session start and two decisions (B 1), and of a fleet's joins and
    two ticks (B 8, B 64), held against the plain version on the same
    tensors as in phase 2 (5e-2 absolute and the exact limit); one decision
    and one tick under ``torch.profiler`` (device time, copy records) with
    their copies counted at PyTorch's dispatcher: exactly one
    host-to-device and one device-to-host copy; f32 and int8 deployment
    bundles, the int8 one under 0.45 of the f32 size and served to
    ``finish()``;
11. pretraining at ``bench.py --pretrain``'s shape (``pretrain_config``:
    the MAGIC-S student with its KD heads and the MAGIC teacher, 6/2/3
    layers each, CLIP-768 features, vocabulary 50,265, 200-token
    instructions, ``PathDataBuilder``'s defaults (8 steps, gmap 48), batch
    48, AdamW at 5e-5, in-step KD at alpha 0.5, the packed kernel on in
    both models, f32), random weights from a seed: per task (mlm, mrc,
    sap, cfp) one warm-up and three timed steps on device batches
    (synchronised ms, every metric finite, peak memory, the host's build
    time a batch), each step launching ``packed_attention`` 6 (mlm) or 20
    times from the teacher's forward, all on the SIMT route, and
    ``fused_attention`` never; a 12-step ``fit`` through
    ``PrefetchLoader`` (wall, examples/s); one ``validate`` (the student's
    66 launches); one sap step under ``torch.profiler``; every packed call
    of a sap step (the teacher, H 12) and of a validate (the student, H 2)
    held against the plain version (2e-5 and the exact limit), the
    teacher's six shapes timed against their bound, the plain version and
    SDPA; and a sap step with the teacher on its einsum path;
12. golden pretraining step: ``tests/fixtures/golden_pretrain_11.npz`` (a
    tiny JAX student and teacher, the spec, one batch a task, JAX's
    metrics, gradient norms and leaves after one sgd step) through the
    port's step on the card in f32, TF32 off, the teacher on the packed
    kernel: every metric to 1e-5, the norms and leaves to 1e-4;
13. the navigation CLI (``vln_magic_tpu_torch.cli.main_nav``) with the
    shipped scripts' flags on a dataset tree in the reference's layout
    (``write_dataset_tree``: 3 scans x 320 viewpoints, R2R annotations
    with 200-token encodings, RxR ones with 250, no HDF5 file, so the hash
    feature store at CLIP width 768), each run in this process with the
    kernel counts at 0 before and read after, which must stay 0 (no flag
    sets ``use_pallas_attention``, as in JAX): (a) ``run_r2r_valid.sh``
    plus ``--test --detailed_output`` from a ``.pt`` of seeded MAGIC-S
    weights: finite metrics, the submission files, items/s per split, and
    val_seen's predictions equal to ``Navigator.evaluate`` called
    directly; (b) ``run_r2r_kdl.sh`` (MAGIC teacher + MAGIC-S, f32) for 2
    iterations, then ``--auto_resume`` to 4: the files of training, finite
    metrics, ms an iteration, peak memory; (c) ``run_rxr_kdl.sh`` (T 28,
    250 tokens, gmap 208, the nDTW expert) for 1 iteration: ms a step, the
    device events of one expert call, and on one DAgger state the nDTW
    scores on the card within 1e-5 of the CPU's and equal expert actions;
    (d) ``--mode serve`` in a child process over a pipe, episodes on a
    64-node scan until 12 decisions, ``save``/``restore`` mid-episode,
    every decision equal to an in-process ``NavServer`` session,
    ``latency_ms``;
14. the model options (ROADMAP Queue 1 item 5) at the main path's shape,
    on phase 4's navigator, world and items: (a) a ``fuse_branches`` wave
    (the same weights; both cross-modal branches as one trunk, each
    attention one ``packed_attention`` launch at batch 2B): 126 launches,
    all on the tensor-core route, every call held against the plain
    version (5e-2 and the exact limit), its wall, device time and idle
    share (``torch.profiler``) beside an unfused wave's, the share of
    equal trajectories; (b) in f32 (SIMT route) the intervention fixture
    ``tests/fixtures/golden_interventions_5.npz`` (JAX's fused logits to
    1e-5, its decode's actions equal) and a fused-branch decode of the
    golden weights equal to ``tests/golden_decode.json``; (c) a wave with
    all five intervention heads and seeded dictionaries (81-row backdoors,
    24 frontdoor exemplars a family): 216 launches; (d) an ``ensemble_n``
    3 wave: 6 launches (the deterministic language encoder); (e) after
    phase 13's runs and on its tree, each run counted as there (0
    launches): ``--mode extract_cfp_features`` (2,000 rows), ``valid``
    with every text, view and map head, the dictionaries rebuilt on the
    train split (language, CFP and k-means timed apart), ``train`` with
    ``--z_instr_update --update_iter 1`` for 2 iterations (both roles'
    dictionaries refreshed each), ``valid --ensemble_n 3 --for_debug``;
15. the back-translation speaker (``agent/speaker.py``,
    ``models/speaker.py``), each path counted for attention launches,
    which must stay 0 (every speaker attention is the einsum path, as
    JAX's ``use_pallas=False``): (a) in f32 the golden speaker,
    ``tests/fixtures/golden_speaker_17.npz`` (JAX's weights, logits, loss,
    gradients, greedy and beam-3 decodes at length penalty 1 and 0.7):
    logits to 1e-5, the loss to 1e-6 relative, the gradients to 1e-5
    relative L2, the tokens equal, the beam scores to 1e-5; (b) at the
    reference contract's width (vocabulary 992, hidden 512, word 256, 3
    layers, 4 heads, CLIP-768 + 128 angle features, 15 steps, 80 tokens,
    batch 16) on phase 4's world and items: ms a ``train_step`` (median of
    3 after a warm-up), peak memory, ms a greedy ``infer_batch`` and a
    beam-4 ``back_translate`` with the host's ``path_features`` apart,
    device launches a decode, BLEU from the C++ library (its results equal
    to the numpy versions on a random corpus); (c) ``Trainer.fit(speaker=)``
    at ``bench.py --train``'s shape, a train batch then a back-translated
    aug batch (the wall of each, the back-translation's share); (d)
    ``cli.train_speaker`` at full width (``--synthetic_feat_dim 768``) for 3
    iterations and a ``--speaker`` resume; and, on phase 13's tree before
    it is removed, ``run_r2r_kdl.sh``'s student recipe without the
    distillation, with an aug split and ``--use_transpeaker``, for two
    iterations, then a ``--speaker
    speaker_latest.pt --loadOptim`` run that writes the ``loaded speaker
    checkpoint`` record line;
16. the mesh (``parallel``): (a) one process over NCCL at world size 1,
    through ``make_mesh``: ``Navigator.use_mesh`` decodes phase 4's items
    in one wave (216 launches, all tensor-core, phase 4's navigator's
    trajectories), ``Trainer.use_mesh`` takes one default train step at
    ``bench.py --train``'s shape beside a trainer without a mesh (the same
    batch and seed; the loss within 1e-4 relative, both walls),
    ``PretrainTrainer.use_mesh`` one sap step (20 SIMT launches); (b) two
    processes of this script (``--mesh-rank``) on the one card over gloo,
    which carries CUDA tensors where NCCL refuses two ranks on one device:
    a dp 2 and then an mp 2 wave of the main path's model at depth 2/1/1
    in f32, 32 items, each rank's trajectories equal to one process's and
    its metrics within 1e-5, every mp packed call (one head a rank) held
    against the plain version;
17. long context (``ops/ema.py``, ``models/mega.py``, ``models/luna.py``,
    ``models/lra.py``) and the rest of ``utils/``: the golden fixture
    ``tests/fixtures/golden_long_context_23.npz`` (JAX's EMA scan, Mega
    block, Luna layer, the LRA classifier's logits with each trunk and
    three ``lra_train_step``s, on weights drawn from its seed) to 1e-4;
    one LRA Text train step per trunk (4,096 tokens, batch 32, ``lra.py``'s
    widths; ms, peak memory, idle share; 0 attention launches, each step
    under ``NanGuard``); ``utils.profiling.trace`` around a wave names the
    packed kernel, ``device_memory_stats`` gives the card's figures.

Then the script's wall, the per-kernel summary line, the card line, and
the result line.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_TOL, BF16_TOL = 2e-5, 5e-2
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_FLOPS = {torch.float32: 67e12,            # f32 outside the tensor cores
              torch.bfloat16: 989e12}          # dense bf16 tensor cores
# (name, Lq, Lk, sprel, launches per wave) at the full-width main path
PATH_SHAPES = [("language", 200, 200, False, 6),
               ("panorama", 50, 50, False, 15 * 2),
               ("global_cross", 128, 200, False, 15 * 3),
               ("global_self", 128, 128, True, 15 * 3),
               ("local_cross", 52, 200, False, 15 * 3),
               ("local_self", 52, 52, False, 15 * 3)]
LAUNCHES_PER_WAVE = sum(s[4] for s in PATH_SHAPES)          # 216
LAUNCHES_PER_STEP = (LAUNCHES_PER_WAVE - 6) // 15            # 14
MAIN_BATCH, MAIN_T = 256, 15
STREAM_ITEMS = 4 * MAIN_BATCH
TEACHER = (16, 12)          # MAGIC teacher: B 16 (bench.py's training), H 12
TRAIN_BATCH, TRAIN_STEPS = 16, 3
# timed steps of each training option after its warm-up (the default
# step takes TRAIN_STEPS); one keeps the script within its time limit
OPTION_STEPS = 1
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_train_7.npz")
SERVE_NODES = 64                 # bench.py --serve: one 64-node scan
SERVE_DECISIONS = 200            # decisions measured in sessions
FLEET_SLOTS = (8, 64)            # bench.py --serve --fleet K
FLEET_TICKS = 200                # ticks measured at each K
PRETRAIN_BATCH = 48              # bench.py --pretrain
PRETRAIN_STEPS = 3               # timed steps of each task
PRETRAIN_FIT = 12                # steps of the fit through PrefetchLoader
PRETRAIN_TASKS = ("mlm", "mrc", "sap", "cfp")
# packed launches of one forward at 6/2/3 layers: the language layers for
# mlm; 6 language, 2 panorama and 12 cross-modal for the path tasks
PRETRAIN_LAUNCHES = {"mlm": 6, "mrc": 20, "sap": 20, "cfp": 20, "og": 20}
PRETRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                "golden_pretrain_11.npz")
# (name, B, scans, nodes, candidate slots, hops) of the observed-subgraph
# walk: the parity wave's transition (T + 1 hops) and backtrack at MAGIC-S
# width, the fleet's ticks at K 8 and 64 and a finish (B 1) on the serve
# scan, and tables wider than a warp
WALK_SHAPES = [("parity_transition", MAIN_BATCH, 3, 320, 14, MAIN_T + 1),
               ("parity_backtrack", MAIN_BATCH, 3, 320, 14, 32),
               ("fleet_8_tick", 8, 1, SERVE_NODES, 8, MAIN_T + 1),
               ("fleet_64_tick", 64, 1, SERVE_NODES, 8, MAIN_T + 1),
               ("finish", 1, 1, SERVE_NODES, 8, 32),
               ("wide_c40", 64, 3, 48, 40, 32)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _warmup_stream():
    """One side stream for every warm-up before a capture: each new stream
    that runs a cuBLAS call gets a workspace of its own, kept to the end."""
    return torch.cuda.Stream()


def time_ms(fn, iters=20, reps=5, warmup=3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between two events, so the host's cost of
    each call (Python, checks, the launch) is not in it."""
    side = _warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def eager_ms(fn, iters=20, warmup=3) -> float:
    """Time of one call of ``fn`` as a caller pays it: ``iters`` calls back
    to back between two events.  Where the host takes longer per call than
    the device, this is the host's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, h, lq, lk, hd, dtype, sprel):
    """The least time for one call, in ms, and its two parts: the bytes
    (each input read once, the output written once) over the memory rate,
    and the FLOPs (two products of 2*Lq*Lk*hd per batch row and head) over
    the peak rate of the inputs' type."""
    el = torch.finfo(dtype).bits // 8
    d = h * hd
    nbytes = el * b * (2 * lq * d + 2 * lk * d) + 4 * b * lk
    if sprel:
        nbytes += 4 * b * h * lq * lk
    flops = 4 * b * h * lq * lk * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


def make_inputs(b, h, lq, lk, hd, dtype, sprel, seed, masked_row=False):
    rng = np.random.default_rng(seed)
    d = h * hd
    dev = torch.device("cuda")
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    q, k, v = t(b, lq, d).to(dtype), t(b, lk, d).to(dtype), t(b, lk, d).to(dtype)
    mask = torch.zeros((b, lk), device=dev)
    mask[:, -max(1, lk // 8):] = -1e9          # padded keys
    if masked_row:
        mask[1 % b] = -1e9                      # an ended episode: all masked
    sp = t(b, h, lq, lk) if sprel else None
    return q, k, v, mask, sp


def ptxas_entries(report):
    """ptxas -v's report as ``(mangled kernel name, registers, spill store
    bytes, spill load bytes)`` per entry function."""
    entries = []
    for part in report.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        entries.append((name, int(regs.group(1)) if regs else None,
                        *(int(x) for x in spill.groups())))
    return entries


def phase_card_and_build(card):
    from vln_magic_tpu_torch.ops import attention, build

    reports = {}

    def build_one(name):
        t0 = time.perf_counter()
        build.build((name,), reports=reports)
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.KERNELS)) as pool:
        each = dict(pool.map(build_one, build.KERNELS))
    build_s = time.perf_counter() - t0
    for name in build.KERNELS:
        print(reports.get(name, ""), flush=True)
    print(card, flush=True)
    emit({"phase": "card_and_build", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s, "kernel_build_s_each": each})
    # the fused tensor-core route's instantiations <hd, 16-key chunks, row
    # tiles>
    rows = []
    for name, regs, spill_st, spill_ld in ptxas_entries(
            reports.get("fused_attention", "")):
        m = re.search(r"fused_attention_tc_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                      name)
        if m:
            hd, nch, rt = map(int, m.groups())
            rows.append({"hd": hd, "chunks": nch, "row_tiles": rt,
                         "registers": regs, "spill_stores": spill_st,
                         "spill_loads": spill_ld,
                         "smem_bytes": attention.fused_tc_smem_bytes(hd, nch,
                                                                     rt)})
    emit({"phase": "ptxas",
          "kernel": "fused_attention_tc_kernel<hd, chunks, row tiles>",
          "instantiations": sorted(rows, key=lambda r: (
              r["hd"], r["chunks"], r["row_tiles"])),
          "note": None if rows else "library was already built: no report",
          "card": card})


def phase_kernel_vs_plain(card):
    import torch.nn.functional as F

    from vln_magic_tpu_torch.ops import attention
    from vln_magic_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")     # TF32 off for the plain version's matmuls
    pa, ref = attention.packed_attention, attention.packed_attention_reference

    def plain_must_not_run(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    cases = [(name, 256, 2, lq, lk, 64, sp, False, n)
             for name, lq, lk, sp, n in PATH_SHAPES]
    cases += [("odd_batch", 3, 2, 37, 45, 64, True, False, 0),
              ("ungrouped_h4_hd16", 4, 4, 8, 8, 16, False, False, 0),
              ("fully_masked_row", 4, 2, 16, 24, 64, True, True, 0),
              ("rxr_lk250_hd32", 2, 3, 20, 250, 32, False, False, 0),
              ("hd128", 2, 1, 5, 33, 128, True, True, 0),
              ("lq1_lk1", 1, 2, 1, 1, 64, True, False, 0),
              ("lq15_lk9_hd32", 2, 2, 15, 9, 32, True, False, 0),
              ("lq17_lk17_h4_hd16", 3, 4, 17, 17, 16, False, True, 0),
              ("lq63_lk16", 2, 2, 63, 16, 64, True, False, 0),
              ("lq65_lk255_hd128", 2, 1, 65, 255, 128, True, True, 0),
              ("lk256", 1, 2, 64, 256, 64, True, False, 0),
              ("lk257_simt", 2, 2, 20, 257, 64, True, False, 0)]
    summary = {dname: {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0,
                       "bound_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
                       "ops_ms": 0.0, "max_abs_err": 0.0,
                       "exact_limit_used": 0.0}
               for dname in ("float32", "bfloat16")}
    for seed, (name, b, h, lq, lk, hd, sprel, masked, per_wave) in \
            enumerate(cases):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).split(".")[-1]
            q, k, v, mask, sp = make_inputs(b, h, lq, lk, hd, dtype, sprel,
                                            seed, masked)
            want = ref(q, k, v, mask, sp, h)
            attention.packed_attention_reference = plain_must_not_run
            try:
                tc_before = pa.tc_launches
                got = pa(q, k, v, mask, sp, num_heads=h)
                torch.cuda.synchronize()
                route = "tensor_core" if pa.tc_launches > tc_before else "simt"
                ms = time_ms(lambda: pa(q, k, v, mask, sp, num_heads=h))
                host_ms = eager_ms(lambda: pa(q, k, v, mask, sp, num_heads=h))
            finally:
                attention.packed_attention_reference = ref
            # against the plain version on the same inputs (in bf16 it
            # rounds the scores, which the kernel does not) ...
            err = (got.float() - want.float()).abs().max().item()
            # ... and against the kernel's own arithmetic: the plain version
            # on the f32 upcast, out within one rounding of P and one of out
            exact_err, used = attention.packed_attention_error(
                q, k, v, mask, sp, h, got, atol=F32_TOL)
            want_route = ("tensor_core" if dtype == torch.bfloat16
                          and lk <= attention.MAX_TC_KEYS else "simt")
            if not (torch.isfinite(got).all() and err <= tol and used <= 1.0
                    and route == want_route):
                raise AssertionError(
                    f"{name} {dname} ({route} route, want {want_route}): max "
                    f"abs err {err} (tol {tol}); against f32 arithmetic "
                    f"{exact_err}, {used:.3f} of its limit")
            plain_ms = time_ms(lambda: ref(q, k, v, mask, sp, h))
            # yardstick only: one PyTorch call computing the same function
            split = lambda x: x.view(b, x.shape[1], h, hd).transpose(1, 2)
            bias = mask[:, None, None, :] + (sp if sprel else 0.0)
            bias = bias.to(dtype)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                split(q), split(k), split(v), attn_mask=bias))
            bound_ms, bytes_ms, ops_ms = bound(b, h, lq, lk, hd, dtype, sprel)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            emit({"phase": "kernel_vs_plain", "shape": name,
                  "B": b, "H": h, "Lq": lq, "Lk": lk, "hd": hd,
                  "sprel": sprel, "dtype": dname, "route": route,
                  "max_abs_err": err, "tol": tol,
                  "exact_max_abs_err": exact_err,
                  "exact_limit_used": used, "ms": ms, "eager_ms": host_ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "launches_per_wave": per_wave, "card": card})
            if per_wave:
                wave = summary[dname]
                for key, val in (("ms", ms), ("eager_ms", host_ms),
                                 ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms),
                                 ("library_ms", lib_ms),
                                 ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    wave[key] += per_wave * val
                wave["max_abs_err"] = max(wave["max_abs_err"], err)
                wave["exact_limit_used"] = max(wave["exact_limit_used"], used)

    # malformed input raises instead of reaching either version
    q, k, v, mask, _ = make_inputs(2, 2, 4, 4, 24, torch.float32, False, 0)
    try:
        pa(q, k, v, mask, None, num_heads=2)
    except ValueError:
        pass
    else:
        raise AssertionError("head dim 24 was accepted")
    emit({"phase": "kernel_vs_plain_per_wave",
          "per": f"the six path shapes x their launches ({LAUNCHES_PER_WAVE})",
          **summary, "card": card})
    return summary["bfloat16"]


def _walk_cases():
    """tests/torch_walk_cases.py, the walk's seeded graphs and its two
    plain versions (the torch loop and the NumPy reference)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_walk_cases

    return torch_walk_cases


def _walk_equal(what, case):
    """The kernel's walk (one launch) against the torch loop on the same
    card tensors, exactly; returns (the kernel's (prev, ln, nodes), the
    mean hops a lane took)."""
    from vln_magic_tpu_torch.ops.walk import observed_walk

    W = _walk_cases()
    n0 = observed_walk.launches
    got = W.rollout_walk(*case)
    loop = W.loop_walk(*case)
    torch.cuda.synchronize()
    if observed_walk.launches - n0 != 1:
        raise AssertionError(f"walk {what}: {observed_walk.launches - n0} "
                             f"kernel launches, want 1")
    for name, g, w in zip(("prev", "ln", "nodes"), got, loop):
        if not torch.equal(g, w):
            raise AssertionError(f"walk {what}: {name} differs from the "
                                 f"torch loop on the same tensors")
    return got, (got[1] - case[5]).float().mean().item()


def phase_walk_vs_plain(card):
    """Phase 2 (b): the observed-subgraph walk's kernel against the torch
    loop (``Rollout._walk_loop``) on the same card tensors at each of
    ``WALK_SHAPES``, two seeded graphs a shape (the odd seed's noisy
    distances make walks cycle to the hop bound), exactly, with one launch
    a walk; each row gives the kernel's device time (``time_ms``) and its
    time as a caller pays it, and the loop's both."""
    W = _walk_cases()
    rows = []
    for i, (name, b, scans, n, c, hops) in enumerate(WALK_SHAPES):
        for seed in (2 * i, 2 * i + 1):
            case = W.make_case(seed, b, c, n=n, s=scans,
                               chords=n * c if c > 32 else None,
                               device="cuda")[:-1] + (hops,)
            _, mean_hops = _walk_equal(f"{name} seed {seed}", case)
            tables, state, target, moving, nodes, ln, _ = case
            r, out = W.walker(tables), nodes.clone()  # each call writes alike
            kernel = lambda: r._walk_observed(state, target, moving, hops,
                                              out, ln)
            loop = lambda: r._walk_loop(state, target, moving, hops, out, ln)
            row = {"phase": "walk_vs_plain", "shape": name, "seed": seed,
                   "B": b, "N": n, "C": c, "hops": hops,
                   "mean_hops_taken": mean_hops, "equal_to_loop": True,
                   "ms": time_ms(kernel), "eager_ms": eager_ms(kernel),
                   "plain_ms": time_ms(loop), "plain_eager_ms": eager_ms(loop),
                   "card": card}
            rows.append(row)
            emit(row)
    return rows


@contextlib.contextmanager
def _captured_walks():
    """Inside, each ``Rollout._walk_observed`` call's inputs are cloned
    before it runs, the first call at each (batch, hops) only; yields the
    dict of them, each a case as ``_walk_equal`` takes it."""
    from types import SimpleNamespace

    from vln_magic_tpu_torch.agent.rollout import Rollout

    real, seen = Rollout._walk_observed, {}

    def capture(self, state, target, moving, hops, nodes, ln):
        key = (state.batch_size, hops)
        if key not in seen:
            c = torch.clone
            seen[key] = (
                SimpleNamespace(cand_ids=c(self.t.cand_ids),
                                cand_mask=c(self.t.cand_mask),
                                cand_dist=c(self.t.cand_dist)),
                SimpleNamespace(batch_size=state.batch_size,
                                scan=c(state.scan), cur=c(state.cur),
                                visited=c(state.visited),
                                obs_dist=c(state.obs_dist)),
                c(target), c(moving), c(nodes), c(ln), hops)
        return real(self, state, target, moving, hops, nodes, ln)

    Rollout._walk_observed = capture
    try:
        yield seen
    finally:
        Rollout._walk_observed = real


def _check_walks(what, seen, want_keys):
    """Replay each captured walk: the kernel against the torch loop on the
    same tensors (``_walk_equal``); ``want_keys``, the (batch, hops) that
    must have been met.  Returns one row per walk."""
    if set(seen) != set(want_keys):
        raise AssertionError(f"{what}: walks at (batch, hops) "
                             f"{sorted(seen)}, want {sorted(want_keys)}")
    rows = []
    for (b, hops), case in sorted(seen.items()):
        _, mean_hops = _walk_equal(f"{what} B {b} hops {hops}", case)
        rows.append({"B": b, "hops": hops, "N": case[0].cand_ids.shape[1],
                     "C": case[0].cand_ids.shape[2],
                     "mean_hops_taken": mean_hops, "equal_to_loop": True})
    return rows


def golden_config(parity=False, lanes=8):
    from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig,
                                            ModelConfig, TrainConfig)

    return MagicConfig(
        model=ModelConfig(vocab_size=400, hidden_size=64,
                          num_attention_heads=2, num_l_layers=2,
                          num_pano_layers=1, num_x_layers=2,
                          image_feat_size=24, max_position_embeddings=64,
                          use_pallas_attention=True),
        env=EnvConfig(max_action_len=8, max_gmap_len=24, max_instr_len=48,
                      observed_graph_parity=parity),
        train=TrainConfig(batch_size=lanes, compute_dtype="float32"))


def phase_golden(card):
    """Both pinned golden decodes on the card, then the golden model
    streamed over 4 lanes against its own wave decode."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.ops.attention import packed_attention

    world = make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                 seed=777)
    flat = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                     "golden_params_777.npz")))
    items = make_synthetic_instructions(world, 8, np.random.default_rng(777),
                                        vocab_size=400, min_path=3,
                                        max_path=6)
    for golden, parity in (("golden_decode.json", False),
                           ("golden_decode_parity.json", True)):
        nav = Navigator(golden_config(parity), world, params=flat,
                        device="cuda")
        packed_attention.launches = packed_attention.tc_launches = 0
        (_, _), preds = nav.evaluate(items, batch_size=8)
        got = [p["trajectory_idx"] for p in preds]
        with open(os.path.join(ROOT, "tests", golden)) as f:
            want = json.load(f)
        for ep, (g, w) in enumerate(zip(got, want)):
            if g != w:
                step = next(i for i in range(max(len(g), len(w)))
                            if i >= len(g) or i >= len(w) or g[i] != w[i])
                raise AssertionError(f"{golden} differs at episode {ep}, "
                                     f"step {step}: {g} vs {w}")
        if len(got) != len(want):
            raise AssertionError(f"{golden}: episode count differs")
        if packed_attention.tc_launches:
            raise AssertionError(f"{golden}: an f32 call took the "
                                 f"tensor-core route")
        emit({"phase": "golden_decode", "golden": golden, "parity": parity,
              "episodes": len(got), "match": True,
              "kernel_launches": packed_attention.launches,
              "route": "simt", "card": card})

    # streaming equals waves: 4 lanes, 10 items of one instruction length
    nav = Navigator(golden_config(lanes=4), world, params=flat,
                    device="cuda")
    items = make_synthetic_instructions(world, 10, np.random.default_rng(1),
                                        vocab_size=400, min_path=3,
                                        max_path=6)
    rng = np.random.default_rng(2)
    for it in items:
        it["instr_encoding"] = rng.integers(4, 400, 40).astype(np.int32)
    (_, _), waves = nav.evaluate(items, stream=False)
    (avg, _), streamed = nav.evaluate(items, stream=True)
    for ep, (w, st) in enumerate(zip(waves, streamed)):
        if w["trajectory_idx"] != st["trajectory_idx"]:
            raise AssertionError(f"streamed episode {ep} differs from its "
                                 f"wave decode: {st} vs {w}")
    emit({"phase": "golden_stream_equals_waves", "lanes": 4,
          "episodes": len(items), "match": True,
          "scan_steps": avg["scan_steps"], "card": card})


# ---- phase 14's golden interventions (tests/fixtures/golden_interventions_5.npz)

# a small MAGIC-S with all five intervention heads (door), the packed kernel
# on; JAX's weights, dictionaries, fused logits and actions are the fixture
GOLDEN_INTERVENTIONS_SPEC = {
    "seed": 5,
    "world": {"num_scans": 1, "nodes_per_scan": 16, "feat_dim": 24,
              "seed": 5},
    "items": {"num_items": 6, "vocab_size": 200, "min_path": 2,
              "max_path": 5},
    "model": {"vocab_size": 200, "hidden_size": 32, "num_attention_heads": 2,
              "num_l_layers": 2, "num_pano_layers": 1, "num_x_layers": 2,
              "image_feat_size": 24, "max_position_embeddings": 64,
              "kd_heads": True, "kd_target_size": 48,
              "use_pallas_attention": True, "do_back_txt": True,
              "do_back_img": True, "do_front_txt": True,
              "do_front_img": True, "do_front_his": True,
              "do_add_method": "door"},
    "env": {"max_action_len": 5, "max_gmap_len": 16, "max_instr_len": 32},
    "train": {"batch_size": 6, "compute_dtype": "float32"},
    # backdoor rows (padded with p 0), frontdoor rows, image-backdoor rows
    "dicts": {"direction": 3, "landmark": 5, "pad": 8, "front": 4,
              "img": 6},
    "nav_batch": {"B": 3, "LT": 12, "P": 9, "G": 7},
}
INTERVENTIONS_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                     "golden_interventions_5.npz")
NAV_ARGS = ("txt_embeds", "txt_masks", "gmap_img_embeds", "gmap_step_ids",
            "gmap_pos_fts", "gmap_masks", "gmap_visited_masks",
            "gmap_pair_dists", "vp_img_embeds", "vp_pos_fts", "vp_masks",
            "vp_nav_masks", "gmap_local_slot", "vp_cand_visited")


def interventions_config(module, spec=GOLDEN_INTERVENTIONS_SPEC):
    """``spec``'s ``MagicConfig`` from ``module`` (either package's
    ``config``)."""
    return module.MagicConfig(model=module.ModelConfig(**spec["model"]),
                              env=module.EnvConfig(**spec["env"]),
                              train=module.TrainConfig(**spec["train"]))


def interventions_zdicts(spec=GOLDEN_INTERVENTIONS_SPEC) -> dict:
    """The student's rollout dictionaries of ``spec``, numpy from its seed
    (``build_rollout_zdicts``' layout plus the image backdoor's
    ``z_img_feats``/``z_img_pzs``): backdoor rows padded with p(z) 0."""
    m, n = spec["model"], spec["dicts"]
    rng = np.random.default_rng(spec["seed"] + 100)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)

    def back(rows):
        p = np.zeros((n["pad"], 1), np.float32)
        p[:rows, 0] = rng.random(rows) + 0.1
        p[:rows] /= p.sum()
        feats = np.zeros((n["pad"], m["hidden_size"]), np.float32)
        feats[:rows] = f(rows, m["hidden_size"])
        return feats, p

    dzf, dzp = back(n["direction"])
    lzf, lzp = back(n["landmark"])
    front = m["kd_target_size"] if m["kd_heads"] else m["hidden_size"]
    img_p = rng.random((n["img"], 1)).astype(np.float32)
    return {"instr_zdict": {"direction_features": dzf, "direction_pzs": dzp,
                            "landmark_features": lzf, "landmark_pzs": lzp},
            "front_txt_feats": f(n["front"], front),
            "front_vp_feats": f(n["front"], front),
            "front_gmap_feats": f(n["front"], front),
            "z_img_feats": f(n["img"], m["image_feat_size"]),
            "z_img_pzs": img_p / img_p.sum()}


def interventions_nav_inputs(model_cfg, spec=GOLDEN_INTERVENTIONS_SPEC):
    """One ``navigation`` batch (and language/panorama inputs) of numpy
    arrays from ``spec``'s seed, with padded text, views and map tokens."""
    nb = spec["nav_batch"]
    b, lt, p, g = nb["B"], nb["LT"], nb["P"], nb["G"]
    rng = np.random.default_rng(spec["seed"] + 200)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    d, p2 = model_cfg.hidden_size, p + 2
    txt_masks = np.ones((b, lt), bool)
    txt_masks[:, -3:] = False
    pano_masks = np.ones((b, p), bool)
    pano_masks[:, -2:] = False
    gmap_masks = np.ones((b, g), bool)
    gmap_masks[:, 1] = gmap_masks[:, -1] = False
    gmap_visited = np.zeros((b, g), bool)
    gmap_visited[:, 1:3] = True
    vp_nav = np.ones((b, p2), bool)
    vp_nav[:, 1] = False
    vp_nav[:, -4:] = False
    return {
        "txt_ids": rng.integers(2, model_cfg.vocab_size, (b, lt)
                                ).astype(np.int32),
        "txt_masks": txt_masks,
        "view_img_fts": f(b, p, model_cfg.image_feat_size),
        "loc_fts": f(b, p, model_cfg.loc_feat_size),
        "nav_types": rng.integers(0, 3, (b, p)).astype(np.int32),
        "pano_masks": pano_masks,
        "txt_embeds": f(b, lt, d),
        "gmap_img_embeds": f(b, g, d),
        "gmap_step_ids": rng.integers(0, 5, (b, g)).astype(np.int32),
        "gmap_pos_fts": f(b, g, model_cfg.gmap_pos_size),
        "gmap_masks": gmap_masks,
        "gmap_visited_masks": gmap_visited,
        "gmap_pair_dists": np.abs(f(b, g, g)) * 5.0,
        "vp_img_embeds": f(b, p2, d),
        "vp_pos_fts": f(b, p2, model_cfg.vp_pos_size),
        "vp_masks": np.concatenate([np.ones((b, 2), bool), pano_masks], 1),
        "vp_nav_masks": vp_nav,
        "gmap_local_slot": rng.integers(-1, p2, (b, g)).astype(np.int32),
        "vp_cand_visited": (rng.random((b, p2)) < 0.3).astype(np.float32),
    }


def golden_interventions(device="cuda"):
    """The intervention fixture through the port on ``device`` in f32:
    the navigation batch's fused logits against JAX's (1e-5) and the
    decode of the fixture's items with the student's dictionaries (actions
    equal).  Returns the error, the actions' agreement and the packed
    kernel's launches in the decode."""
    from vln_magic_tpu_torch import config as tcfg
    from vln_magic_tpu_torch.agent.interventions import nested_zdicts
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.ops.attention import packed_attention

    fx = dict(np.load(INTERVENTIONS_FIXTURE))
    spec = json.loads(str(fx["spec"]))
    cfg = interventions_config(tcfg, spec)
    part = lambda pre: {k[len(pre):]: v for k, v in fx.items()
                        if k.startswith(pre)}
    world = make_synthetic_world(**spec["world"])
    items = make_synthetic_instructions(
        world, rng=np.random.default_rng(spec["seed"]), **spec["items"])
    nav = Navigator(cfg, world, params=part("params/"), device=device)
    zd = nested_zdicts(part("zd/"))
    x = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                             else v).to(nav.device)
         for k, v in part("nav/").items()}
    b = x["txt_masks"].shape[0]
    bz = lambda a: torch.from_numpy(a).to(nav.device).expand(b, *a.shape)
    with torch.no_grad():
        outs = nav.model.navigation(
            *[x[k] for k in NAV_ARGS],
            front_vp_feats=bz(zd["front_vp_feats"]),
            front_gmap_feats=bz(zd["front_gmap_feats"]))
    err = float((outs["fused_logits"].float().cpu()
                 - torch.from_numpy(fx["fused_logits"])).abs().max())
    packed_attention.launches = packed_attention.tc_launches = 0
    _, aux = nav.run_items(items, zdicts={"student": zd})
    actions = aux["actions"].cpu().numpy()
    same = bool(np.array_equal(actions, fx["actions"]))
    if not (err < F32_TOL and same):
        raise AssertionError(f"golden interventions: fused logits max abs "
                             f"err {err}, actions equal {same}")
    return {"max_abs_err": err, "actions_equal": same,
            "kernel_launches": packed_attention.launches,
            "tc_launches": packed_attention.tc_launches}


def main_config():
    """``bench.py``'s default shape (``bench.py:110-132``): MAGIC-S, hidden
    128, 2 heads of 64, 6/2/3 layers, CLIP-768, 200-token instructions,
    gmap 128, T 15, bf16, the packed kernel on."""
    from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig,
                                            ModelConfig, TrainConfig)

    return MagicConfig(
        model=ModelConfig(hidden_size=128, num_attention_heads=2,
                          num_l_layers=6, num_pano_layers=2, num_x_layers=3,
                          image_feat_size=768, use_pallas_attention=True),
        env=EnvConfig(max_action_len=MAIN_T, max_gmap_len=128,
                      max_instr_len=200),
        train=TrainConfig(batch_size=MAIN_BATCH, compute_dtype="bfloat16"))


def build_main_path():
    """The full-width MAGIC-S navigator on the card, its world and 256
    items: (navigator, items, set-up seconds)."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    batch, txt_len = MAIN_BATCH, 200
    cfg = main_config()
    t0 = time.perf_counter()
    world = make_synthetic_world(num_scans=3, nodes_per_scan=320,
                                 feat_dim=768, seed=0)
    rng = np.random.default_rng(0)
    items = make_synthetic_instructions(world, batch, rng, min_path=4,
                                        max_path=7)
    for it in items:    # full-length 200-token instructions
        it["instr_encoding"] = rng.integers(4, 1000, txt_len).astype(np.int32)
    nav = Navigator(cfg, world, seed=0, device="cuda")
    return nav, items, time.perf_counter() - t0


def check_decode(world, items, avg, preds):
    """Finite metrics, one prediction per item, and trajectories that walk
    graph edges from each item's start."""
    if len(preds) != len(items) or not all(
            math.isfinite(v) for v in avg.values()):
        raise AssertionError(f"bad evaluation output: {avg}")
    for p, it in zip(preds, items):
        g = world.graphs[p["scan_idx"]]
        flat = [n for seg in p["trajectory_idx"] for n in seg]
        if flat[0] != it["path_idx"][0] or not all(
                g.adjacency[a, b] for a, b in zip(flat[:-1], flat[1:])):
            raise AssertionError(f"trajectory off the graph: {flat}")


def timed_evaluate(nav, items, **kw):
    """``nav.evaluate`` with the launch counts set to 0 just before it and
    read just after: (avg, preds, wall seconds, launches)."""
    from vln_magic_tpu_torch.ops.attention import (fused_attention,
                                                   packed_attention)
    from vln_magic_tpu_torch.ops.walk import observed_walk

    torch.cuda.synchronize()
    packed_attention.launches = packed_attention.tc_launches = 0
    fused_attention.launches = observed_walk.launches = 0
    t0 = time.perf_counter()
    (avg, _), preds = nav.evaluate(items, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return avg, preds, wall, {
        "packed_attention": packed_attention.launches,
        "packed_attention_tensor_core": packed_attention.tc_launches,
        "fused_attention": fused_attention.launches,
        "observed_walk": observed_walk.launches}


def check_tensor_cores(what, launches):
    """Every bf16 ``packed_attention`` launch of a run took the tensor-core
    route."""
    if launches["packed_attention_tensor_core"] != launches["packed_attention"]:
        raise AssertionError(
            f"{what}: {launches['packed_attention_tensor_core']} of "
            f"{launches['packed_attention']} packed_attention launches took "
            f"the tensor-core route")


def phase_main_path(card):
    batch, t_steps = MAIN_BATCH, MAIN_T
    nav, items, setup_s = build_main_path()
    nav.evaluate(items)                 # warm-up: cuBLAS handles, caches
    avg, preds, wall, launches = timed_evaluate(nav, items)
    waves = math.ceil(len(items) / batch)
    if launches["packed_attention"] != LAUNCHES_PER_WAVE * waves:
        raise AssertionError(f"packed_attention launched {launches} times, "
                             f"want {LAUNCHES_PER_WAVE} x {waves}")
    check_tensor_cores("main path", launches)
    if launches["observed_walk"]:
        raise AssertionError(f"main path: the walk kernel launched "
                             f"{launches['observed_walk']} times, want 0 "
                             f"(no observed-graph parity)")
    check_decode(nav.world, items, avg, preds)
    emit({"phase": "main_path", "batch": batch, "waves": waves,
          "T": t_steps, "setup_s": setup_s, "wall_s": wall,
          "semantic_steps_per_s": avg["semantic_steps"] / wall,
          "padded_steps_per_s": batch * waves * t_steps / wall,
          "metrics": avg, "kernels": launches, "card": card})
    return nav, items, launches["packed_attention"]


def phase_streaming(card, nav):
    """1,024 items over the main path's 256 lanes, streamed; then the same
    items in waves, for the share of equal decodes (bf16: reported, not
    gated) and the walls side by side."""
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    world, lanes = nav.world, MAIN_BATCH
    rng = np.random.default_rng(1)
    items = make_synthetic_instructions(world, STREAM_ITEMS, rng, min_path=4,
                                        max_path=7)
    for it in items:
        it["instr_encoding"] = rng.integers(4, 1000, 200).astype(np.int32)
    avg, preds, wall, launches = timed_evaluate(nav, items)
    chunk = nav.stream_eval(lanes).chunk
    chunks = int(avg["scan_steps"]) // chunk
    want = (6 * (STREAM_ITEMS // lanes)
            + LAUNCHES_PER_STEP * int(avg["scan_steps"]))
    if launches["packed_attention"] != want:
        raise AssertionError(f"streaming launched packed_attention "
                             f"{launches['packed_attention']} times, want "
                             f"{want} ({chunks} chunks of {chunk} steps)")
    check_tensor_cores("streaming", launches)
    check_decode(world, items, avg, preds)
    w_avg, w_preds, w_wall, _ = timed_evaluate(nav, items, stream=False)
    same = sum(a["trajectory_idx"] == b["trajectory_idx"]
               for a, b in zip(preds, w_preds)) / len(items)
    emit({"phase": "streaming", "items": STREAM_ITEMS, "lanes": lanes,
          "chunk_steps": chunk, "chunks": chunks, "wall_s": wall,
          "semantic_steps_per_s": avg["semantic_steps"] / wall,
          "padded_steps_per_s": lanes * avg["scan_steps"] / wall,
          "waves_wall_s": w_wall,
          "waves_semantic_steps_per_s": w_avg["semantic_steps"] / w_wall,
          "share_equal_to_waves": same, "metrics": avg,
          "kernels": launches, "card": card})
    return launches["packed_attention"]


def phase_parity(card, wave_nav, items):
    """One full-width wave with observed-graph parity on: the main path's
    world, items and weights (seed 0)."""
    from vln_magic_tpu_torch.agent.navigator import Navigator

    cfg = wave_nav.cfg
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, observed_graph_parity=True))
    nav = Navigator(cfg, wave_nav.world, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    avg, preds, wall, launches = timed_evaluate(nav, items)
    # one walk a step's transition and one for the backtrack
    if (launches["packed_attention"], launches["observed_walk"]) != (
            LAUNCHES_PER_WAVE, MAIN_T + 1):
        raise AssertionError(f"parity launched (packed_attention, "
                             f"observed_walk) {launches}, want "
                             f"({LAUNCHES_PER_WAVE}, {MAIN_T + 1})")
    check_tensor_cores("parity", launches)
    check_decode(nav.world, items, avg, preds)
    peak = torch.cuda.max_memory_allocated()
    # the wave again, its first transition's and its backtrack's walks
    # replayed on the torch loop
    with _captured_walks() as seen:
        _, again = nav.evaluate(items)
    same = sum(a["trajectory_idx"] == b["trajectory_idx"]
               for a, b in zip(again, preds)) / len(preds)
    walks = _check_walks("parity", seen, [(MAIN_BATCH, MAIN_T + 1),
                                          (MAIN_BATCH, 32)])   # WALK_HOPS
    emit({"phase": "parity", "batch": MAIN_BATCH, "T": MAIN_T,
          "wall_s": wall,
          "semantic_steps_per_s": avg["semantic_steps"] / wall,
          "peak_memory_gb": peak / 1e9,
          "resident_before_gb": resident / 1e9,
          "metrics": avg, "kernels": launches, "walks": walks,
          "share_equal_on_second_wave": same, "card": card})
    return launches["packed_attention"], launches["observed_walk"], walks


def fused_bound(b, h, lq, lk, hd, dtype, full_bias):
    """The least time of one ``fused_attention`` call, in ms, and its two
    parts: q, k, v and out at the inputs' width, the f32 bias as read
    ([B, 1, 1, Lk] or [B, H, Lq, Lk]) and the f32 map [B, Lq, Lk], over the
    memory rate; 4*B*H*Lq*Lk*hd FLOPs over the inputs' peak rate."""
    el = torch.finfo(dtype).bits // 8
    nbytes = (el * b * h * hd * (2 * lq + 2 * lk)
              + 4 * (b * h * lq * lk if full_bias else b * lk)
              + 4 * b * lq * lk)
    flops = 4 * b * h * lq * lk * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


def fused_inputs(b, h, lq, lk, hd, dtype, full_bias, seed, masked_row=False):
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    q, k, v = (t(b, h, l, hd).to(dtype) for l in (lq, lk, lk))
    bias = t(b, h, lq, lk) if full_bias else t(b, 1, 1, lk)
    bias[..., -max(1, lk // 8):] = -1e9            # padded keys
    if masked_row:
        bias[1 % b] = -1e9                         # an ended episode
    return q, k, v, bias


def misaligned(x):
    """A copy of ``x`` two bytes past a 16-byte boundary: the fused
    wrapper sends it to the SIMT route."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = flat[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    return y


def phase_fused(card):
    """``fused_attention`` against its plain version, then its entry point
    once at each MAGIC-S path shape with the launches counted.  No single
    PyTorch call computes both outputs (``scaled_dot_product_attention``
    returns no probability map), so there is no library time."""
    from vln_magic_tpu_torch.ops import attention

    fa, ref = attention.fused_attention, attention.fused_attention_reference

    def plain_must_not_run(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    def checked(q, k, v, bias, want, tol, what):
        """One call, its route, and both outputs held to the plain version's
        ``want`` and to the kernel's own arithmetic."""
        attention.fused_attention_reference = plain_must_not_run
        try:
            tc_before = fa.tc_launches
            out, probs = fa(q, k, v, bias)
            torch.cuda.synchronize()
        finally:
            attention.fused_attention_reference = ref
        route = "tensor_core" if fa.tc_launches > tc_before else "simt"
        err = (out.float() - want[0].float()).abs().max().item()
        exact_err, map_err, used = attention.fused_attention_error(
            q, k, v, bias, out, probs, atol=F32_TOL)
        if not (torch.isfinite(out).all() and torch.isfinite(probs).all()
                and err <= tol and map_err <= F32_TOL and used <= 1.0):
            raise AssertionError(
                f"fused {what} ({route} route): max abs err {err} (tol "
                f"{tol}); against f32 arithmetic: map {map_err} (tol "
                f"{F32_TOL}), out {exact_err}, {used:.3f} of its limit")
        return route, err, (probs - want[1]).abs().max().item(), \
            exact_err, map_err, used

    def timed(q, k, v, bias):
        attention.fused_attention_reference = plain_must_not_run
        try:
            return (time_ms(lambda: fa(q, k, v, bias)),
                    eager_ms(lambda: fa(q, k, v, bias)))
        finally:
            attention.fused_attention_reference = ref

    cases = [(f"magic_s_{name}", MAIN_BATCH, 2, lq, lk, 64, sp, False)
             for name, lq, lk, sp, _ in PATH_SHAPES]
    cases += [(f"teacher_{name}", TEACHER[0], TEACHER[1], lq, lk, 64, sp,
               False) for name, lq, lk, sp, _ in PATH_SHAPES]
    cases += [("odd_batch", 3, 2, 37, 45, 64, True, False),
              ("hd16", 4, 4, 8, 8, 16, False, False),
              ("hd32_rxr_lk250", 2, 3, 20, 250, 32, False, False),
              ("fully_masked_row", 4, 2, 16, 24, 64, True, True),
              ("hd128", 2, 1, 5, 33, 128, True, True)]
    summary = {"ms": 0.0, "eager_ms": 0.0, "simt_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "max_abs_err": 0.0, "exact_limit_used": 0.0}
    for seed, (name, b, h, lq, lk, hd, full, masked) in enumerate(cases):
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            dname = str(dtype).split(".")[-1]
            q, k, v, bias = fused_inputs(b, h, lq, lk, hd, dtype, full,
                                         seed, masked)
            want = ref(q, k, v, bias)
            # against the plain version on the same inputs (in bf16 it
            # rounds the scores, which the kernel does not), and against
            # the kernel's own arithmetic: the plain version on the f32
            # upcast, the map to 2e-5, out within one rounding of P and one
            # of out (attention.fused_attention_error)
            route, err, plain_map_err, exact_err, map_err, used = checked(
                q, k, v, bias, want, tol, f"{name} {dname}")
            want_route = ("tensor_core" if dtype == torch.bfloat16
                          else "simt")
            if route != want_route:
                raise AssertionError(f"fused {name} {dname}: {route} route, "
                                     f"want {want_route}")
            ms, host_ms = timed(q, k, v, bias)
            simt = {}
            if dtype == torch.bfloat16:
                # the SIMT route on the same inputs, timed beside it
                mq, mk, mv = map(misaligned, (q, k, v))
                simt_route, *_ = checked(mq, mk, mv, bias, want, tol,
                                         f"{name} {dname} misaligned")
                if simt_route != "simt":
                    raise AssertionError(f"fused {name}: misaligned inputs "
                                         f"took the {simt_route} route")
                simt["simt_ms"] = timed(mq, mk, mv, bias)[0]
            plain_ms = time_ms(lambda: ref(q, k, v, bias))
            bound_ms, bytes_ms, ops_ms = fused_bound(b, h, lq, lk, hd, dtype,
                                                     full)
            emit({"phase": "fused_vs_plain", "shape": name, "B": b, "H": h,
                  "Lq": lq, "Lk": lk, "hd": hd, "full_bias": full,
                  "dtype": dname, "route": route, "max_abs_err": err,
                  "tol": tol, "plain_map_max_abs_err": plain_map_err,
                  "exact_max_abs_err": exact_err,
                  "exact_limit_used": used,
                  "map_max_abs_err": map_err, "map_tol": F32_TOL,
                  "ms": ms, "eager_ms": host_ms, **simt,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "library_ms": None, "card": card})
            if dtype == torch.bfloat16 and name.startswith("magic_s_"):
                for key, val in (("ms", ms), ("eager_ms", host_ms),
                                 ("simt_ms", simt["simt_ms"]),
                                 ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms),
                                 ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    summary[key] += val
                summary["max_abs_err"] = max(summary["max_abs_err"], err)
                summary["exact_limit_used"] = max(summary["exact_limit_used"],
                                                  used)

    # the entry point's own path: one call at each MAGIC-S shape, bf16
    inputs = [fused_inputs(MAIN_BATCH, 2, lq, lk, 64, torch.bfloat16, sp, i)
              for i, (_, lq, lk, sp, _) in enumerate(PATH_SHAPES)]
    torch.cuda.synchronize()
    attention.packed_attention.launches = fa.launches = fa.tc_launches = 0
    outs = [fa(*x) for x in inputs]
    torch.cuda.synchronize()
    launches, tc_launches = fa.launches, fa.tc_launches
    if launches != len(PATH_SHAPES) or tc_launches != launches:
        raise AssertionError(f"fused_attention launched {launches} times, "
                             f"{tc_launches} on the tensor-core route; want "
                             f"{len(PATH_SHAPES)}, all tensor-core")
    bits = lambda x: x.view(torch.int16 if x.dtype == torch.bfloat16
                            else torch.int32)
    for x, (out, probs) in zip(inputs, outs):
        rows = probs.sum(-1)
        if (out.shape != x[0].shape or not torch.isfinite(out).all()
                or (rows - 1).abs().max().item() > 1e-5):
            raise AssertionError("fused_attention entry point: bad output")
        again = fa(*x)       # deterministic: no atomics in the head sum
        if not (torch.equal(bits(again[0]), bits(out))
                and torch.equal(bits(again[1]), bits(probs))):
            raise AssertionError("fused_attention: two calls on the same "
                                 "inputs gave different bits")
    emit({"phase": "fused_entry_point", "calls": len(PATH_SHAPES),
          "kernels": {"fused_attention": launches,
                      "fused_attention_tensor_core": tc_launches,
                      "packed_attention": attention.packed_attention.launches},
          "repeat_bitwise_equal": True, "card": card})
    summary["launches"], summary["tc_launches"] = launches, tc_launches
    return summary


def train_config():
    """``bench.py --train``'s configuration (bench.py:98-180): the MAGIC
    teacher and the MAGIC-S student (its packed kernel switched on, which a
    training call never takes), bf16 compute, DAgger with sampled
    feedback, MAKD + MKTD + MKRW + ICoD."""
    from vln_magic_tpu_torch.config import (DistillConfig, EnvConfig,
                                            MagicConfig, ModelConfig,
                                            TrainConfig)

    depth = {"num_l_layers": 6, "num_pano_layers": 2, "num_x_layers": 3,
             "image_feat_size": 768, "kd_heads": True}
    return MagicConfig(
        model=ModelConfig(hidden_size=128, num_attention_heads=2,
                          kd_target_size=768, use_pallas_attention=True,
                          **depth),
        teacher_model=ModelConfig(hidden_size=768, num_attention_heads=12,
                                  kd_target_size=128, **depth),
        env=EnvConfig(max_action_len=MAIN_T, max_gmap_len=128,
                      max_instr_len=200),
        train=TrainConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                          train_alg="dagger", ml_weight=0.2, lr=4e-5,
                          optim="adamw", grad_clip=40.0,
                          dagger_sample="sample"),
        distill=DistillConfig(train_kdl=True, train_teacher=True,
                              teacher_sample_hard_mining=True,
                              adaptive_ability_weight=True,
                              adaptive_ability_weight_type="RW"))


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def device_breakdown(prof, wall_ms, top=10):
    """Device kernels of a ``torch.profiler`` run: their summed time, the
    device's busy time and idle share over ``wall_ms``, the launch count
    and the ``top`` kernels by device time.  It reads the profiler's raw
    records (``kineto_results``): building its per-op event tree instead
    takes about 2 minutes for a train step's 10^5 kernels."""
    from collections import defaultdict

    kernels = [(e.name(), e.start_ns() / 1e3,
                (e.start_ns() + e.duration_ns()) / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name = defaultdict(lambda: [0, 0.0])
    for name, start, end in kernels:
        by_name[name][0] += 1
        by_name[name][1] += end - start
    busy_ms = _busy_us([(start, end) for _, start, end in kernels]) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_kernel_ms": sum(v[1] for v in by_name.values()) / 1e3,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": len(kernels),
            "top_kernels": [{"name": k[:120], "count": c, "ms": us / 1e3}
                            for k, (c, us) in ranked]}


def _reset_launches():
    from vln_magic_tpu_torch.ops.attention import (fused_attention,
                                                   packed_attention)
    from vln_magic_tpu_torch.ops.walk import observed_walk

    packed_attention.launches = packed_attention.tc_launches = 0
    fused_attention.launches = fused_attention.tc_launches = 0
    observed_walk.launches = 0


def _launches():
    from vln_magic_tpu_torch.ops.attention import (fused_attention,
                                                   packed_attention)

    return {"packed_attention": packed_attention.launches,
            "fused_attention": fused_attention.launches}


# the training options phase 8 times beside the default step, each a
# TrainConfig change on the same trainer
TRAIN_VARIANTS = {"bf16_grads": {"grads_dtype": "bfloat16"},
                  "remat_dots": {"remat": True, "remat_policy": "dots"},
                  "remat_dots_all": {"remat": True,
                                     "remat_policy": "dots_all"},
                  "fused": {"fuse_rollouts": True}}


class _CastCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the dtype casts (``aten._to_copy``, autocast's among them)
    that run under it; each launches one kernel on the card."""

    def __init__(self):
        super().__init__()
        self.casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.casts += func is torch.ops.aten._to_copy.default
        return func(*args, **(kwargs or {}))


def _check_steps(what, metrics, launches):
    """Finite metrics, ``grad_norm`` > 0 and no attention launch."""
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{what}: a metric is not finite: {metrics}")
    if not all(m["grad_norm"] > 0 for m in metrics):
        raise AssertionError(f"{what}: grad_norm 0: {metrics}")
    if any(launches.values()):
        raise AssertionError(f"{what} launched attention kernels: "
                             f"{launches}")


def _moved(before, models) -> dict:
    """The share of each model's parameters that differ from ``before``."""
    return {k: sum(not torch.equal(a, p) for a, p in zip(
        before[k], m.parameters())) / len(before[k])
        for k, m in models.items()}


def _timed_steps(step, models, what, steps=TRAIN_STEPS, count_casts=False):
    """One warm-up and ``steps`` timed train steps: ms each, their median,
    the peak memory, the metrics, the moved share of each model and the
    attention launches, checked (``_check_steps``, every model moved);
    with ``count_casts`` the warm-up's casts (``_CastCounter``, which
    slows the warm-up)."""
    counter = _CastCounter() if count_casts else contextlib.nullcontext()
    with counter:
        warm_ms, _ = step()
    before = {k: [p.detach().clone() for p in m.parameters()]
              for k, m in models.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    timed = [step() for _ in range(steps)]
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = _moved(before, models)
    del before
    metrics = [m for _, m in timed]
    _check_steps(what, metrics, launches)
    if not all(share > 0 for share in moved.values()):
        raise AssertionError(f"{what}: a model did not move: {moved}")
    out = {"warmup_ms": warm_ms, "ms_per_step": [ms for ms, _ in timed],
           "median_ms_per_step": float(np.median([ms for ms, _ in timed])),
           "peak_memory_gb": peak_gb, "metrics": metrics,
           "moved_share": moved, "kernels": launches}
    if count_casts:
        out["casts"] = counter.casts
    return out


def phase_training(card, world):
    """Phase 8: the full-width MAKD + ICoD DAgger train step, then the
    training options beside it."""
    from torch.profiler import ProfilerActivity, profile

    from vln_magic_tpu_torch.agent.trainer import Trainer
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    cfg = train_config()
    t0 = time.perf_counter()
    tr = Trainer(cfg, world, device="cuda")
    rng = np.random.default_rng(2)
    items = make_synthetic_instructions(world, TRAIN_BATCH, rng, min_path=4,
                                        max_path=7)
    for it in items:    # full-length 200-token instructions
        it["instr_encoding"] = rng.integers(4, 1000, 200).astype(np.int32)
    setup_s = time.perf_counter() - t0

    def step(trainer=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = (trainer or tr).train_step(items)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, m

    def profiled():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ms, _ = step()
        return ms, prof

    models = {"student": tr.model, "teacher": tr.teacher_model}
    parts_s = {}
    t0 = time.perf_counter()
    default = _timed_steps(step, models, "training", count_casts=True)
    launches = {"default": default["kernels"]}
    parts_s["default"] = time.perf_counter() - t0

    tr.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, remat=True))
    torch.cuda.reset_peak_memory_stats()
    remat_ms, remat_m = step()
    remat_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tr.cfg = cfg
    if not all(math.isfinite(v) for v in remat_m.values()):
        raise AssertionError(f"training with remat: {remat_m}")

    t0 = time.perf_counter()
    profiled_ms, prof = profiled()
    wall_ms = default["median_ms_per_step"]
    emit({"phase": "training", "batch": TRAIN_BATCH, "T": MAIN_T,
          "setup_s": setup_s, **default, "remat_ms": remat_ms,
          "remat_peak_memory_gb": remat_peak_gb, "remat_metrics": remat_m,
          "card": card})
    emit({"phase": "training_profile", "profiled_ms": profiled_ms,
          **device_breakdown(prof, wall_ms), "card": card})
    del prof
    parts_s["profile"] = time.perf_counter() - t0

    # the repair's cost: the same steps with autocast's weight cache on
    # (the port before it), where every use of a weight reads one cast
    t0 = time.perf_counter()
    tr.autocast = lambda: torch.autocast("cuda", dtype=torch.bfloat16)
    cached = _timed_steps(step, models, "training, autocast cache on",
                          steps=OPTION_STEPS, count_casts=True)
    del tr.autocast
    launches["autocast_cache"] = cached["kernels"]
    emit({"phase": "training_autocast_cache", **cached,
          "repaired_median_ms_per_step": wall_ms,
          "repaired_casts": default["casts"], "card": card})
    parts_s["autocast_cache"] = time.perf_counter() - t0

    from vln_magic_tpu_torch.agent.rollout import REMAT_SAVED

    variants = {}
    for name, train in TRAIN_VARIANTS.items():
        tr.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, **train))
        tr.rollout.remat_ops.clear()
        t0 = time.perf_counter()
        variants[name] = _timed_steps(step, models, f"training {name}",
                                      steps=OPTION_STEPS)
        parts_s[name] = time.perf_counter() - t0
        launches[name] = variants[name]["kernels"]
        if tr.rollout.remat_ops:
            # the product ops the layers reach on this card, a step, and
            # whether the policy saved them
            policy = REMAT_SAVED[train["remat_policy"]]
            variants[name]["remat_products_per_step"] = {
                str(op): {"n": n / (OPTION_STEPS + 1),
                          "saved": op in policy}
                for op, n in tr.rollout.remat_ops.items()
                if any(k in str(op) for k in ("mm", "matmul", "linear",
                                              "einsum", "conv", "dot"))}
        emit({"phase": "training_option", "option": name, "train": train,
              **variants[name], "card": card})
    t0 = time.perf_counter()
    fused_profiled_ms, prof = profiled()
    tr.cfg = cfg
    emit({"phase": "training_fused_profile", "profiled_ms": fused_profiled_ms,
          **device_breakdown(prof, variants["fused"]["median_ms_per_step"]),
          "card": card})
    del prof
    parts_s["fused_profile"] = time.perf_counter() - t0

    # the 'grad' ability weights' refresh on the batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    norms = tr.update_ability_grads(items)
    torch.cuda.synchronize()
    ability = {"ms": (time.perf_counter() - t0) * 1e3,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "ability_grads": norms.tolist(), "kernels": _launches()}
    launches["ability_grads"] = ability["kernels"]
    if not (np.all(np.isfinite(norms)) and np.all(norms > 0)) \
            or any(ability["kernels"].values()):
        raise AssertionError(f"update_ability_grads: {ability}")
    emit({"phase": "training_ability_grads", "items": len(items), **ability,
          "card": card})
    del tr, models
    t0 = time.perf_counter()

    # one A2C step: the teacher frozen, so that the critic trains (under
    # ICoD JAX's step takes the teacher's partition instead)
    a2c_cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, train_alg="a2c"),
        distill=dataclasses.replace(cfg.distill, train_teacher=False))
    a2c = Trainer(a2c_cfg, world, device="cuda")
    a2c_step = _timed_steps(lambda: step(a2c), {"student": a2c.model,
                                                "critic": a2c.critic},
                            "training a2c", steps=1)
    launches["a2c"] = a2c_step["kernels"]
    emit({"phase": "training_option", "option": "a2c",
          "train": {"train_alg": "a2c", "train_teacher": False}, **a2c_step,
          "card": card})
    parts_s["a2c"] = time.perf_counter() - t0
    emit({"phase": "training_parts", "seconds": parts_s, "card": card})
    return launches


def golden_train_step(device="cuda"):
    """The port's ``compute_grads`` on the golden JAX training step
    (``TRAIN_FIXTURE``): returns the errors against JAX's values, and
    raises when one is over its tolerance (the objective 1e-5 relative,
    each partition's gradient norm 1e-4 relative, each kept gradient leaf
    1e-4 of its largest magnitude)."""
    from vln_magic_tpu_torch.agent.trainer import Trainer
    from vln_magic_tpu_torch.config import config_from_dict
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.utils.weights import load_trainer_params

    fx = dict(np.load(TRAIN_FIXTURE))
    spec = json.loads(str(fx["spec"]))
    world = make_synthetic_world(**spec["world"])
    items = make_synthetic_instructions(
        world, rng=np.random.default_rng(spec["seed"]), **spec["items"])
    tr = Trainer(config_from_dict(spec["config"]), world, device=device)
    tree = lambda part: {k[len(part) + 1:]: v for k, v in fx.items()
                         if k.startswith(part + "/")}
    load_trainer_params(tr, tree("params"), tree("t_params"),
                        tree("critic_params"))
    loss, grads = tr.compute_grads(items, seed=spec["seed"])
    want = float(fx["loss"])
    errs = {"loss_rel": abs(loss.item() - want) / abs(want)}
    # written "not <=" so that a NaN fails
    bad = [f"objective {loss.item()} against {want}"] \
        if not errs["loss_rel"] <= 1e-5 else []
    for part, g in grads.items():
        norm = math.sqrt(sum(float((x.double() ** 2).sum())
                             for x in g.values()))
        want = float(fx[f"grad_norm/{part}"])
        errs[f"grad_norm_rel/{part}"] = abs(norm - want) / want
        if not errs[f"grad_norm_rel/{part}"] <= 1e-4:
            bad.append(f"{part} gradient norm {norm} against {want}")
        for k, w in tree(f"grad/{part}").items():
            e = float(np.max(np.abs(g[k].cpu().numpy() - w))
                      / np.max(np.abs(w)))
            errs[f"leaf_rel/{part}/{k}"] = e
            if not e <= 1e-4:
                bad.append(f"{part} {k}: {e} of its largest")
    if bad:
        raise AssertionError("golden training step: " + "; ".join(bad))
    return errs


# the golden training options (ROADMAP Queue 1 item 2): two JAX
# compute_grads runs (the fused DAgger step with fusion='local', an aug
# batch and the 'grad' ability weights; an A2C step, sampled feedback
# taken as argmax on both sides), one update_ability_grads and seven
# steps of each new optimizer on a named tree, weights drawn from the
# seed (seeded_flax_params), so that the fixture holds JAX's results only
GOLDEN_OPTIONS_SPEC = {
    "seed": 13,
    "world": {"num_scans": 1, "nodes_per_scan": 14, "feat_dim": 16,
              "seed": 9},
    "items": {"num_items": 4, "vocab_size": 120, "min_path": 2,
              "max_path": 4},
    "model": {"vocab_size": 120, "hidden_size": 32, "num_attention_heads": 2,
              "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
              "image_feat_size": 16, "max_position_embeddings": 64,
              "kd_heads": True, "kd_target_size": 64, "hidden_dropout": 0.0,
              "attention_dropout": 0.0},
    "teacher_model": {"hidden_size": 64, "kd_target_size": 32},
    "env": {"max_action_len": 4, "max_gmap_len": 16, "max_instr_len": 32},
    "runs": {
        "fused": {"model": {"fusion": "local"},
                  "train": {"batch_size": 4, "train_alg": "dagger",
                            "ml_weight": 0.2, "dagger_sample": "argmax",
                            "fuse_rollouts": True},
                  "distill": {"train_kdl": True, "train_teacher": True,
                              "teacher_sample_hard_mining": True,
                              "adaptive_ability_weight": True,
                              "adaptive_ability_weight_type": "grad"}},
        "a2c": {"model": {},
                "train": {"batch_size": 4, "train_alg": "a2c",
                          "ml_weight": 0.2},
                "distill": {"train_kdl": True, "train_teacher": False,
                            "teacher_sample_hard_mining": True,
                            "adaptive_ability_weight": True,
                            "adaptive_ability_weight_type":
                                "learned_weight"}},
        # the a2c run with bf16 weight-gradient sums (f32 compute)
        "a2c_bf16": {"model": {},
                     "train": {"batch_size": 4, "train_alg": "a2c",
                               "ml_weight": 0.2, "grads_dtype": "bfloat16"},
                     "distill": {"train_kdl": True, "train_teacher": False,
                                 "teacher_sample_hard_mining": True,
                                 "adaptive_ability_weight": True,
                                 "adaptive_ability_weight_type":
                                     "learned_weight"}}},
    # the fused run's ability-gradient norms (the 'grad' weights' input)
    "ability_grads": [3.0, 1.0, 4.0, 1.5, 2.5],
    # its aug table: the world's features with the views rolled by one
    "aug_roll": 1,
    "optim": {"steps": 7, "lr": 0.01, "grad_clip": 1.0,
              "weight_decay": 0.01, "grad_std": 0.06,
              "runs": [["radam", False], ["ralamb", False],
                       ["rangerlars", False], ["rms", False],
                       ["radam", True], ["ralamb", True],
                       ["rangerlars", True], ["rms", True],
                       ["adamw", True]],
              "tree": {
                  "params.lang_encoder.embeddings.word_embeddings.embedding":
                      [12, 8],
                  "params.lang_encoder.embeddings.emb_norm.scale": [8],
                  "params.lang_encoder.layer_0.attention.query.kernel":
                      [8, 8],
                  "params.local_encoder.layer_0.ffn.output.kernel": [16, 8],
                  "params.local_sap_head.dense.bias": [16],
                  "params.pano_encoder.img_proj.kernel": [16, 8],
                  "params.global_encoder.layer_0.ffn.output.bias": [8],
                  "params.kdl_global_weight": []}},
}
OPTIONS_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "golden_train_options_13.npz")
FIX_FLAGS = ("fix_lang_embedding", "fix_local_branch", "fix_pano_embedding")


def options_config(module, run, spec=GOLDEN_OPTIONS_SPEC):
    """The ``run`` configuration of ``spec`` as a ``MagicConfig`` of
    ``module`` (either package's ``config``)."""
    r = spec["runs"][run]
    model = module.ModelConfig(**{**spec["model"], **r["model"]})
    return module.MagicConfig(
        model=model,
        teacher_model=dataclasses.replace(model, **spec["teacher_model"]),
        env=module.EnvConfig(**spec["env"]),
        train=module.TrainConfig(**r["train"]),
        distill=module.DistillConfig(**r["distill"]))


def seeded_flax_params(shapes: dict, seed: int) -> dict:
    """Weights for flax names -> shapes, drawn from ``seed`` in sorted name
    order: 0.05 N(0, 1), plus 1 for LayerNorm scales.  Both packages draw
    the same arrays from their own names."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        x = np.array(rng.standard_normal(shapes[name]), np.float32)
        x *= 0.05
        if name.endswith(".scale"):
            x += 1.0
        out[name] = x
    return out


def seeded_trainer_weights(trainer, seed: int) -> None:
    """``seeded_flax_params`` into the port trainer's student (``seed``),
    teacher (``seed + 1``) and critic (``seed + 7``)."""
    from vln_magic_tpu_torch.utils.weights import (_flax_names,
                                                   load_trainer_params)

    def flat(model, s):
        return seeded_flax_params(
            {k: tuple(p.t().shape if tr else p.shape)
             for k, (p, tr) in _flax_names(model).items()}, s)

    load_trainer_params(
        trainer, flat(trainer.model, seed),
        None if trainer.teacher_model is None
        else flat(trainer.teacher_model, seed + 1),
        flat(trainer.critic, seed + 7))


def options_world_items(module, spec=GOLDEN_OPTIONS_SPEC):
    """The options' world, items and aug table, from either package's
    ``env`` module."""
    world = module.make_synthetic_world(**spec["world"])
    items = module.synthetic.make_synthetic_instructions(
        world, rng=np.random.default_rng(spec["seed"]), **spec["items"])
    aug = np.roll(np.asarray(world.tables.features), spec["aug_roll"], axis=2)
    return world, items, aug


class _SampleAsArgmax:
    """``Rollout.select_action`` of ``rollout_cls`` taking ``sample`` as
    ``argmax`` while active, so that the A2C rollout draws alike in both
    packages."""

    def __init__(self, rollout_cls):
        self.cls, self.orig = rollout_cls, rollout_cls.select_action

    def __enter__(self):
        orig = self.orig

        def select(ro, logits, feedback, *args, **kwargs):
            return orig(ro, logits,
                        "argmax" if feedback == "sample" else feedback,
                        *args, **kwargs)

        self.cls.select_action = select

    def __exit__(self, *exc):
        self.cls.select_action = self.orig


def options_optimizer_run(kind, fix, spec=GOLDEN_OPTIONS_SPEC):
    """The port's optimizer ``kind`` (``fix``: every ``fix_*`` flag on)
    for ``spec["optim"]["steps"]`` steps on the seeded named tree with
    seeded gradients: the parameters after each step, by name [steps,
    ...]."""
    from vln_magic_tpu_torch.agent.trainer import make_optimizer
    from vln_magic_tpu_torch.config import MagicConfig, TrainConfig

    o = spec["optim"]
    names = sorted(o["tree"])
    params = [torch.from_numpy(v) for v in
              seeded_flax_params(o["tree"], spec["seed"]).values()]
    cfg = MagicConfig(train=TrainConfig(
        optim=kind, lr=o["lr"], grad_clip=o["grad_clip"],
        weight_decay=o["weight_decay"], **{f: fix for f in FIX_FLAGS}))
    opt = make_optimizer(cfg, params, names=names)
    rng = np.random.default_rng(spec["seed"] + 1)
    out = {k: [] for k in names}
    with torch.no_grad():
        for _ in range(o["steps"]):
            for p in params:
                p.grad = torch.from_numpy(np.asarray(
                    o["grad_std"] * rng.standard_normal(tuple(p.shape)),
                    np.float32))
            opt.step()
            for k, p in zip(names, params):
                out[k].append(p.numpy().copy())
    return {k: np.stack(v) for k, v in out.items()}


def golden_train_options(device="cuda"):
    """The port on the golden training options (``OPTIONS_FIXTURE``): the
    fused run's and the A2C runs' ``compute_grads`` (the objective to 1e-5
    relative, each partition's gradient norm and kept leaf to 1e-4; the
    bf16-gradient A2C run's gradients to 1e-2, the order of the bf16
    sums), the ability-gradient norms of one ``update_ability_grads``
    (1e-4 relative) and each optimizer's seven steps (1e-5 relative, 1e-7
    absolute).  Returns the errors; raises when one is over its
    tolerance."""
    from vln_magic_tpu_torch import config as tcfg
    from vln_magic_tpu_torch import env as tenv
    from vln_magic_tpu_torch.agent.rollout import Rollout
    from vln_magic_tpu_torch.agent.trainer import Trainer

    spec = GOLDEN_OPTIONS_SPEC
    fx = dict(np.load(OPTIONS_FIXTURE))
    if json.loads(str(fx["spec"])) != json.loads(json.dumps(spec)):
        raise AssertionError("golden options: the fixture's spec is not "
                             "GOLDEN_OPTIONS_SPEC")
    world, items, aug = options_world_items(tenv)
    errs, bad = {}, []

    def check(key, got, want, rtol, atol=0.0):
        scale = float(np.max(np.abs(want))) if np.size(want) else 0.0
        err = float(np.max(np.abs(np.asarray(got) - want))) if np.size(
            want) else 0.0
        errs[key] = err / scale if scale else err
        if not err <= rtol * scale + atol:
            bad.append(f"{key}: {err} against {rtol} x {scale}")

    for run in spec["runs"]:
        tr = Trainer(options_config(tcfg, run), world, device=device,
                     aug_features=aug if run == "fused" else None)
        seeded_trainer_weights(tr, spec["seed"])
        if run == "fused":
            tr.ability_grads = np.asarray(spec["ability_grads"], np.float32)
            loss, grads = tr.compute_grads(items, seed=spec["seed"], aug=True)
        else:
            with _SampleAsArgmax(Rollout):
                loss, grads = tr.compute_grads(items, seed=spec["seed"])
        check(f"{run}/loss", loss.item(), fx[f"{run}/loss"], 1e-5)
        gtol = 1e-2 if tr.cfg.train.grads_dtype == "bfloat16" else 1e-4
        for part, g in grads.items():
            norm = math.sqrt(sum(float((x.double() ** 2).sum())
                                 for x in g.values()))
            check(f"{run}/grad_norm/{part}", norm,
                  fx[f"{run}/grad_norm/{part}"], gtol)
            prefix = f"{run}/grad/{part}/"
            for k in [k for k in fx if k.startswith(prefix)]:
                check(k, g[k[len(prefix):]].cpu().numpy(), fx[k], gtol)
        if run == "fused":
            tr.ability_grads = np.zeros(5, np.float32)
            check("ability_grads", tr.update_ability_grads(items),
                  fx["ability_grads"], 1e-4)
    for kind, fix in spec["optim"]["runs"]:
        for k, v in options_optimizer_run(kind, fix).items():
            check(f"optim/{kind}/{int(fix)}/{k}", v,
                  fx[f"optim/{kind}/{int(fix)}/{k}"], 1e-5, 1e-7)
    if bad:
        raise AssertionError("golden training options: " + "; ".join(bad))
    return errs


def phase_golden_train(card):
    """Phase 9: the JAX golden training step and the golden training
    options in f32, TF32 off."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("golden training: TF32 is on")
    errs = golden_train_step()
    emit({"phase": "golden_train", "fixture": os.path.relpath(
        TRAIN_FIXTURE, ROOT), "errors": errs,
          "max_leaf_rel": max(v for k, v in errs.items()
                              if k.startswith("leaf")),
          "tf32": torch.backends.cuda.matmul.allow_tf32, "card": card})
    _reset_launches()
    errs = golden_train_options()
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"golden training options launched attention "
                             f"kernels: {launches}")
    worst = lambda prefix: max(v for k, v in errs.items()
                               if k.startswith(prefix))
    emit({"phase": "golden_train_options", "fixture": os.path.relpath(
        OPTIONS_FIXTURE, ROOT), "max_rel": {
            p: worst(p) for p in ("fused/", "a2c/", "a2c_bf16/",
                                  "ability_grads", "optim/")},
          "errors": {k: v for k, v in errs.items()
                     if not k.startswith("optim/")},
          "kernels": launches,
          "tf32": torch.backends.cuda.matmul.allow_tf32, "card": card})


def served(world, sess, item, steps, on_step=None):
    """Drive ``sess`` through ``item`` from its start, observations replayed
    from ``world``: (world-index actions, -1 for a stop; the decisions).
    ``on_step(step)`` wraps each decision (launch counts)."""
    from vln_magic_tpu_torch.agent.serving import observation_from_world

    g = world.graphs[item["scan_idx"]]
    cur = int(item["path_idx"][0])
    actions, decs = [], []
    for _ in range(steps):
        obs = observation_from_world(world, item["scan_idx"], cur,
                                     float(item["heading"]))
        dec = on_step(lambda: sess.step(obs)) if on_step else sess.step(obs)
        decs.append(dec)
        if dec.target is not None:
            cur = g.index[dec.target]
        actions.append(-1 if dec.target is None else cur)
        if dec.stop:
            break
    return actions, decs


def served_fleet(world, fleet, items, steps, on_tick=None):
    """All ``items`` through ``fleet`` at once, one tick per step:
    (actions per item, ``finish()`` records, per tick (ms, decisions,
    what ``on_tick`` returned))."""
    from vln_magic_tpu_torch.agent.serving import observation_from_world

    sessions = [fleet.join(it["instr_encoding"]) for it in items]
    cur = [int(it["path_idx"][0]) for it in items]
    actions = [[] for _ in items]
    ticks = []
    for _ in range(steps):
        obs = {s.slot: observation_from_world(
            world, items[i]["scan_idx"], cur[i], float(items[i]["heading"]))
            for i, s in enumerate(sessions) if not s._ended}
        if not obs:
            break
        torch.cuda.synchronize()
        if on_tick:
            on_tick(None)
        t0 = time.perf_counter()
        decs = fleet.step(obs)
        ms = (time.perf_counter() - t0) * 1e3
        ticks.append((ms, len(decs), on_tick(decs) if on_tick else None))
        for i, s in enumerate(sessions):
            d = decs.get(s.slot)
            if d is None:
                continue
            g = world.graphs[items[i]["scan_idx"]]
            if d.target is not None:
                cur[i] = g.index[d.target]
            actions[i].append(-1 if d.target is None else cur[i])
    finals = [fleet.finish(s.slot) for s in sessions]
    for s in sessions:
        fleet.release(s.slot)
    return actions, finals, ticks


def _counted(fn):
    """``fn()`` with the packed kernel's counts set to 0 just before and
    read just after: (result, launches, tensor-core launches)."""
    from vln_magic_tpu_torch.ops.attention import packed_attention

    torch.cuda.synchronize()
    packed_attention.launches = packed_attention.tc_launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, packed_attention.launches, packed_attention.tc_launches


def phase_serving_golden(card):
    """Phase 10, f32: every golden episode through a ``NavServer`` session
    and all of them through one ``NavFleet``, each equal to the offline
    parity wave (per-step targets, stop, trajectory with its backtrack);
    then a session saved mid-episode, restored on a fresh server and in a
    fleet slot, continuing as the uninterrupted run."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.agent.serving import (NavFleet, NavServer,
                                                   NavSession,
                                                   observation_from_world)
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    world = make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                 seed=777)
    flat = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                     "golden_params_777.npz")))
    cfg = golden_config(parity=True)
    steps = cfg.env.max_action_len
    items = make_synthetic_instructions(world, 8, np.random.default_rng(777),
                                        vocab_size=400, min_path=3,
                                        max_path=6)
    rng = np.random.default_rng(10)
    for it in items:   # a session pads to max_instr_len, a wave buckets
        it["instr_encoding"] = rng.integers(
            4, 400, cfg.env.max_instr_len).astype(np.int32)
    _, aux = Navigator(cfg, world, params=flat,
                       device="cuda").run_items(items)
    aux = {k: v.cpu().numpy() for k, v in aux.items()}
    n, c = world.tables.max_nodes, world.tables.max_candidates
    server = NavServer(cfg, flat, max_nodes=n, max_cands=c, device="cuda")
    fleet = NavFleet(cfg, model=server.model, slots=len(items), max_nodes=n,
                     max_cands=c, device="cuda")

    def check(what, b, actions, final):
        g = world.graphs[items[b]["scan_idx"]]
        want = aux["actions"][:, b].tolist()
        traj = [g.node_ids[k] for k in
                aux["traj_nodes"][b, :aux["traj_len"][b]].tolist()]
        if (actions + [-1] * (len(want) - len(actions)) != want
                or final["stop_node"] != g.node_ids[aux["stop_node"][b]]
                or final["trajectory"] != traj):
            raise AssertionError(f"{what} episode {b} differs from the "
                                 f"parity wave: {actions}, {final} vs "
                                 f"{want}, {traj}")

    def run_sessions():
        out = []
        for it in items:
            sess = server.new_session(it["instr_encoding"])
            actions, _ = served(world, sess, it, steps)
            out.append((actions, sess.finish()))
        return out

    sessions, launches, tc = _counted(run_sessions)
    (f_actions, f_finals, _), f_launches, f_tc = _counted(
        lambda: served_fleet(world, fleet, items, steps))
    for b, (actions, final) in enumerate(sessions):
        check("session", b, actions, final)
        check("fleet", b, f_actions[b], f_finals[b])
    if tc or f_tc or not launches or not f_launches:
        raise AssertionError(f"golden serving: {launches} + {f_launches} "
                             f"launches, {tc} + {f_tc} on the tensor-core "
                             f"route (f32 takes the SIMT route)")

    # crash recovery: save after the first decision, resume elsewhere
    b = next(i for i, (a, _) in enumerate(sessions) if len(a) >= 2
             and a[0] >= 0)
    it, (want, want_final) = items[b], sessions[b]
    g = world.graphs[it["scan_idx"]]
    blob = os.path.join(kernel_build_dir(), "serving_session.npz")
    sess = server.new_session(it["instr_encoding"])
    first = g.index[sess.step(observation_from_world(
        world, it["scan_idx"], int(it["path_idx"][0]),
        float(it["heading"]))).target]
    sess.save(blob)
    rest_item = dict(it, path_idx=[first])
    fleet2 = NavFleet(cfg, model=server.model, slots=2, max_nodes=n,
                      max_cands=c, device="cuda")
    fleet2.join(items[0]["instr_encoding"])        # slot 0 never submits
    for where, resumed in (
            ("server", NavSession.restore(
                NavServer(cfg, flat, max_nodes=n, max_cands=c,
                          device="cuda"), blob)),
            ("fleet slot 1", fleet2.restore_session(blob))):
        rest, _ = served(world, resumed, rest_item, steps - 1)
        if [first] + rest != want or resumed.finish() != want_final:
            raise AssertionError(f"restored on a {where}: {[first] + rest} "
                                 f"vs {want}")
    os.remove(blob)
    emit({"phase": "serving_golden", "episodes": len(items), "match": True,
          "session_launches": launches, "fleet_launches": f_launches,
          "route": "simt", "fleet_slots": len(items),
          "save_restore": {"episode": b, "decisions": len(want),
                           "server": True, "fleet_slot": 1},
          "card": card})
    return launches + f_launches


def kernel_build_dir():
    from vln_magic_tpu_torch.ops import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    return build.BUILD_DIR


class _DeviceCopies:
    """Counts the copies between host and card that a block asks PyTorch
    for, at its dispatcher: ``htod`` and ``dtoh`` (``to``, ``copy_``,
    ``item``), and ``mixed``, the names of other ops given host and card
    tensors together (an indexed write of a host value copies it to the
    card first)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        self.htod = self.dtoh = 0
        self.mixed = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter.count(func.overloadpacket.__name__, args, out)
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def count(self, name, args, out):
        tensors = [t for t in torch.utils._pytree.tree_leaves(args)
                   if isinstance(t, torch.Tensor)]
        if name in ("_to_copy", "copy_"):
            src, dst = (args[1], args[0]) if name == "copy_" else (args[0],
                                                                   out)
            way = (src.device.type, dst.device.type)
            self.htod += way == ("cpu", "cuda")
            self.dtoh += way == ("cuda", "cpu")
        elif name == "_local_scalar_dense":
            self.dtoh += args[0].is_cuda
        elif len({t.device.type for t in tensors} & {"cpu", "cuda"}) == 2:
            self.mixed.append(name)


def _memcpys(prof):
    """The device's memcpy records of a profiled window by direction, and
    the ``cudaMemcpy*`` runtime calls the host made.  Reported only: the
    records of some windows lack a copy whose runtime call is there."""
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "Memcpy" in e.name]
    return {"htod": sum("HtoD" in nm for nm in dev),
            "dtoh": sum("DtoH" in nm for nm in dev),
            "dtod": sum("DtoD" in nm for nm in dev),
            "memcpy_calls": sum(
                e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cudaMemcpy") for e in prof.events())}


def _profiled(fn, wall_ms):
    """``fn()`` (one decision or tick) under ``torch.profiler`` and
    ``_DeviceCopies``: (its result, its copies and device breakdown).  It
    must ask for one host-to-device and one device-to-host copy and no
    other transfer, as the serving docstring says."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            _DeviceCopies() as copies:
        out = fn()
    packed_us = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "packed_attention" in e.name)
    got = {"htod": copies.htod, "dtoh": copies.dtoh,
           "mixed_device_ops": copies.mixed, "records": _memcpys(prof),
           "packed_attention_ms": packed_us / 1e3,
           **device_breakdown(prof, wall_ms, top=5)}
    if not (copies.htod == 1 and copies.dtoh == 1 and not copies.mixed):
        raise AssertionError(f"a decision or tick asked for {copies.htod} "
                             f"host-to-device and {copies.dtoh} "
                             f"device-to-host copies, and ran "
                             f"{copies.mixed} on host and card tensors "
                             f"together; the serving docstring says one "
                             f"copy each way")
    return out, got


def _stats(ms):
    ms = np.asarray(ms, np.float64)
    return {"mean": float(ms.mean()), "p50": float(np.percentile(ms, 50)),
            "p95": float(np.percentile(ms, 95)), "n": int(ms.size)}


def _captured_packed(fn):
    """``fn()`` with every ``packed_attention`` call the model makes in it
    recorded: ``(fn's result, [(q, k, v, mask_bias, sprel_bias), num_heads,
    out, tensor-core route?] per call)``, the tensors cloned."""
    from vln_magic_tpu_torch.models import layers
    from vln_magic_tpu_torch.ops import attention

    real, pa = layers.packed_attention, attention.packed_attention
    calls = []

    def recorded(q, k, v, mask_bias, sprel_bias=None, *, num_heads):
        tc = pa.tc_launches
        out = real(q, k, v, mask_bias, sprel_bias, num_heads=num_heads)
        calls.append(([None if t is None else t.clone()
                       for t in (q, k, v, mask_bias, sprel_bias)],
                      num_heads, out.clone(), pa.tc_launches > tc))
        return out

    layers.packed_attention = recorded
    try:
        result = fn()
    finally:
        layers.packed_attention = real
    if not calls:
        raise AssertionError("no packed_attention call to check")
    return result, calls


def _check_calls(calls, tol, tensor_cores):
    """Each captured call held against the plain version on the same card
    tensors: within ``tol`` of it and within ``packed_attention_error``'s
    limit of the kernel's own f32 arithmetic, on the tensor-core route if
    ``tensor_cores``, else the SIMT route.  One row per (B, H, Lq, Lk,
    sprel)."""
    from vln_magic_tpu_torch.ops import attention

    rows = {}
    for (q, k, v, mask, sp), h, got, tc in calls:
        want = attention.packed_attention_reference(q, k, v, mask, sp, h)
        err = (got.float() - want.float()).abs().max().item()
        exact_err, used = attention.packed_attention_error(
            q, k, v, mask, sp, h, got, atol=F32_TOL)
        shape = (q.shape[0], h, q.shape[1], k.shape[1], sp is not None)
        if not (torch.isfinite(got).all() and err <= tol and used <= 1.0
                and tc == tensor_cores):
            raise AssertionError(
                f"packed_attention at (B, H, Lq, Lk, sprel) {shape} "
                f"({'tensor-core' if tc else 'SIMT'} route): max abs err "
                f"{err} (tol {tol}); against f32 arithmetic "
                f"{exact_err}, {used:.3f} of its limit")
        row = rows.setdefault(shape, {
            "B": shape[0], "H": h, "Lq": shape[2], "Lk": shape[3],
            "sprel": shape[4], "calls": 0, "max_abs_err": 0.0,
            "exact_limit_used": 0.0})
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["exact_limit_used"] = max(row["exact_limit_used"], used)
    return sorted(rows.values(), key=lambda r: (
        r["B"], r["H"], r["Lq"], r["Lk"], r["sprel"]))


def _checked_packed(fn, tol=BF16_TOL, tensor_cores=True):
    """``fn()`` with every ``packed_attention`` call the model makes in it
    held against the plain version (``_check_calls``).  Returns ``(fn's
    result, one row per (B, H, Lq, Lk, sprel))``."""
    result, calls = _captured_packed(fn)
    return result, _check_calls(calls, tol, tensor_cores)


def phase_serving(card):
    """Phase 10 at ``bench.py --serve``'s shape: sessions (warm-up, then
    episodes until ``SERVE_DECISIONS`` decisions are measured, the first
    episode left out) and fleets of K 8 and 64 (rounds of K episodes until
    ``FLEET_TICKS`` ticks are measured, round 0 left out), the packed
    kernel's launches counted per session start (6) and per decision or tick
    (14), and 6 more in a fleet round's first tick, which encodes the
    round's joins in one batch: 6 a round, not 6 a join; all on the
    tensor-core route; each packed call of a session start,
    two decisions, a fleet's joins and two ticks held against the plain
    version; the walk kernel counted, one launch a decision or tick and one
    a finish, and a decision's, a tick's and a finish's walks replayed on
    the torch loop; one decision and one tick under ``torch.profiler``
    (copies, device time); an int8 bundle round trip."""
    import shutil
    import tempfile
    from collections import Counter

    from vln_magic_tpu_torch.agent.serving import (NavFleet, NavServer,
                                                   observation_from_world)
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
    from vln_magic_tpu_torch.ops.walk import observed_walk
    from vln_magic_tpu_torch.utils.weights import init_params

    cfg = main_config()
    steps = cfg.env.max_action_len
    world = make_synthetic_world(num_scans=1, nodes_per_scan=SERVE_NODES,
                                 feat_dim=768, seed=0)
    c = world.tables.max_candidates
    model = DualScaleVLNBert(cfg.model, dtype=torch.bfloat16, device="cuda")
    init_params(model, 0)
    rng = np.random.default_rng(3)

    def instructions(k):
        items = make_synthetic_instructions(world, k, rng, min_path=4,
                                            max_path=7)
        for it in items:
            it["instr_encoding"] = rng.integers(4, 1000, 200).astype(np.int32)
        return items

    server = NavServer(cfg, model=model, max_nodes=SERVE_NODES, max_cands=c,
                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    def per_decision(step):
        dec, n, tc = _counted(step)
        counts.append((n, tc))
        return dec

    items, lat, starts, counts, lengths, start_ms = [], [], [], [], [], []
    observed_walk.launches = 0
    while len(lat) < SERVE_DECISIONS:
        it = instructions(1)[0]
        items.append(it)
        t0 = time.perf_counter()
        sess, n, tc = _counted(lambda: server.new_session(
            it["instr_encoding"]))
        start_ms.append((time.perf_counter() - t0) * 1e3)
        starts.append((n, tc))
        actions, decs = served(world, sess, it, steps, per_decision)
        sess.finish()
        lengths.append(len(decs))
        if len(items) > 1:  # episode 0 touches the freshly warmed paths again
            lat += [d.latency_ms for d in decs]
    per_start = cfg.model.num_l_layers            # the language encoder
    # one walk a decision's transition and one a finish's backtrack
    session_walks = observed_walk.launches
    if session_walks != sum(lengths) + len(items):
        raise AssertionError(f"serving: the walk kernel launched "
                             f"{session_walks} times over {sum(lengths)} "
                             f"decisions and {len(items)} finishes")
    bad = [x for x in starts if x != (per_start,) * 2] + \
        [x for x in counts if x != (LAUNCHES_PER_STEP,) * 2]
    if bad:
        raise AssertionError(f"serving: (launches, tensor-core launches) "
                             f"{bad[:5]}, want {per_start} a session start "
                             f"and "
                             f"{LAUNCHES_PER_STEP} a decision, all "
                             f"tensor-core")
    it = items[1]
    def two_decisions():
        sess = server.new_session(it["instr_encoding"])
        served(world, sess, it, 2)
        return sess

    with _captured_walks() as seen:
        sess, checked = _checked_packed(two_decisions)
        sess.finish()
    kernel_check = {"session": checked}
    walk_check = {"session": _check_walks("session", seen,
                                          [(1, steps + 1), (1, 32)])}

    # one decision (and the next, if the episode goes on) under the profiler
    sess = server.new_session(it["instr_encoding"])
    obs = observation_from_world(world, 0, int(it["path_idx"][0]),
                                 float(it["heading"]))
    profiled = []
    for _ in range(2):
        dec, copies = _profiled(lambda: sess.step(obs),
                                float(np.median(lat)))
        profiled.append(copies)
        if dec.stop:
            break
        obs = observation_from_world(world, 0, world.graphs[0].index[
            dec.target], 0.0)
    emit({"phase": "serving_session", "nodes": SERVE_NODES, "T": steps,
          "episodes": len(items) - 1, "warmup_s": warmup_s,
          "ms_per_decision": _stats(lat),
          "ms_per_session_start": _stats(start_ms[1:]),
          "decisions_per_episode": dict(sorted(Counter(lengths[1:]).items())),
          "launches_per_session_start": per_start,
          "launches_per_decision": LAUNCHES_PER_STEP, "route": "tensor_core",
          "walk_launches": session_walks,
          "walk_launches_per_decision": 1, "walk_launches_per_finish": 1,
          "profiled_decisions": profiled, "card": card})
    serve_launches = sum(n for n, _ in starts + counts)

    fleets, fleet_launches = {}, 0
    for k in FLEET_SLOTS:
        fleet = NavFleet(cfg, model=model, slots=k, max_nodes=SERVE_NODES,
                         max_cands=c, device="cuda")
        walls, tick_counts, n_dec, measured, rounds = [], [], 0, None, 0
        encode_counts = []   # a round's first tick: its joins' encoding
        tick_walks, round_walks = [], []

        def on_tick(decs):
            from vln_magic_tpu_torch.ops.attention import packed_attention
            if decs is None:
                packed_attention.launches = packed_attention.tc_launches = 0
                on_tick.walks = observed_walk.launches
                return None
            torch.cuda.synchronize()
            tick_walks.append(observed_walk.launches - on_tick.walks)
            return packed_attention.launches, packed_attention.tc_launches

        while len(walls) < FLEET_TICKS:
            f_items = instructions(k)
            observed_walk.launches = 0
            actions, _, ticks = served_fleet(world, fleet, f_items, steps,
                                             on_tick)
            # one walk a tick and one a finish
            round_walks.append((observed_walk.launches, len(ticks) + k))
            encode_counts.append(ticks[0][2])
            tick_counts += [x for _, _, x in ticks[1:]]
            if rounds > 0:  # round 0 pays the first calls at these shapes
                walls += [ms for ms, _, _ in ticks]
                n_dec += sum(d for _, d, _ in ticks)
                measured = measured or (f_items, actions)
            rounds += 1
        first = per_start + LAUNCHES_PER_STEP
        if any(x != (LAUNCHES_PER_STEP,) * 2 for x in tick_counts) or \
                any(x != (first,) * 2 for x in encode_counts):
            raise AssertionError(
                f"fleet {k}: (launches, tensor-core) per tick "
                f"{sorted(set(tick_counts))}, per round's first tick "
                f"{sorted(set(encode_counts))}; want {LAUNCHES_PER_STEP} "
                f"and {first} ({per_start} for the round's {k} joins, "
                f"encoded in one batch), all tensor-core")
        if set(tick_walks) != {1} or any(a != b for a, b in round_walks):
            raise AssertionError(f"fleet {k}: walk launches a tick "
                                 f"{sorted(set(tick_walks))}, (a round, want) "
                                 f"{round_walks[:5]}; want one a tick and "
                                 f"one a finish")
        fleet_launches += sum(n for n, _ in tick_counts + encode_counts)
        # the same items as K standalone sessions (bf16: reported)
        equal = total = 0
        for it, got in zip(*measured):
            want, _ = served(world, server.new_session(it["instr_encoding"]),
                             it, steps)
            total += max(len(want), len(got))
            equal += sum(a == b for a, b in zip(want, got))
        with _captured_walks() as seen:
            _, checked = _checked_packed(lambda: served_fleet(
                world, fleet, instructions(k), 2))
        kernel_check[f"fleet_{k}"] = checked
        walk_check[f"fleet_{k}"] = _check_walks(
            f"fleet {k}", seen, [(k, steps + 1), (1, 32)])
        # one tick under the profiler
        f_items = instructions(k)
        sessions = [fleet.join(it["instr_encoding"]) for it in f_items]
        obs = {s.slot: observation_from_world(
            world, 0, int(it["path_idx"][0]), float(it["heading"]))
            for s, it in zip(sessions, f_items)}
        _, tick_prof = _profiled(lambda: fleet.step(obs),
                                 float(np.median(walls)))
        for s in sessions:
            fleet.release(s.slot)
        fleets[k] = {"ms_per_tick": _stats(walls),
                     "ms_per_decision": float(np.sum(walls)) / n_dec,
                     "decisions": n_dec, "ticks": len(walls),
                     "rounds_measured": rounds - 1,
                     "launches_per_tick": LAUNCHES_PER_STEP,
                     "launches_per_round_encode": per_start,
                     "walk_launches": sum(a for a, _ in round_walks),
                     "walk_launches_per_tick": 1,
                     "walk_launches_per_finish": 1,
                     "share_equal_to_sessions": equal / total,
                     "feature_bank_mb": fleet._features.numel() * 4 / 1e6,
                     "profiled_tick": tick_prof}
        emit({"phase": "serving_fleet", "slots": k, "nodes": SERVE_NODES,
              **fleets[k], "route": "tensor_core", "card": card})
        del fleet
    emit({"phase": "serving_kernel_check", "tol": BF16_TOL,
          "paths": kernel_check, "walks": walk_check, "card": card})

    # deployment bundles: f32 and int8, the int8 one served to finish()
    tmp = tempfile.mkdtemp(dir=kernel_build_dir())
    try:
        sizes = {}
        for name, q in (("f32", False), ("int8", True)):
            server.export_bundle(os.path.join(tmp, name), quantize=q)
            sizes[name] = os.path.getsize(os.path.join(tmp, name,
                                                       "params.npz"))
        if not sizes["int8"] < 0.45 * sizes["f32"]:
            raise AssertionError(f"int8 bundle {sizes}: not under 0.45 of "
                                 f"the f32 one")
        loaded = NavServer.from_bundle(os.path.join(tmp, "int8"),
                                       device="cuda")
        it = items[1]
        sess = loaded.new_session(it["instr_encoding"])
        actions, _ = served(world, sess, it, steps)
        final = sess.finish()
        want, _ = served(world, server.new_session(it["instr_encoding"]),
                         it, steps)
    finally:
        shutil.rmtree(tmp)
    emit({"phase": "serving_bundle", "params_npz_bytes": sizes,
          "int8_share": sizes["int8"] / sizes["f32"],
          "int8_decisions": len(actions),
          "int8_equal_to_bf16_session": actions == want,
          "int8_final_steps": final["steps"], "card": card})
    worst = lambda key: max(r[key] for rows in kernel_check.values()
                            for r in rows)
    return {"serve": serve_launches, "fleet": fleet_launches,
            "serve_walks": session_walks, "walk_check": walk_check,
            "fleet_walks": sum(f["walk_launches"] for f in fleets.values()),
            "session": lat, "fleets": fleets,
            "checked_max_abs_err": worst("max_abs_err"),
            "checked_exact_limit_used": worst("exact_limit_used")}


def pretrain_config():
    """``bench.py --pretrain``'s configuration (bench.py:98-180,
    :359-431): the MAGIC-S student (with its KD heads onto the teacher's
    768) and the MAGIC teacher, 6/2/3 layers each, CLIP-768 features,
    200-token instructions, batch 48, AdamW at 5e-5, in-step KD at alpha
    0.5; the packed kernel on in both models, f32."""
    from vln_magic_tpu_torch.config import (DistillConfig, EnvConfig,
                                            MagicConfig, ModelConfig,
                                            TrainConfig)

    depth = {"num_l_layers": 6, "num_pano_layers": 2, "num_x_layers": 3,
             "image_feat_size": 768, "kd_heads": True,
             "use_pallas_attention": True}
    return MagicConfig(
        model=ModelConfig(hidden_size=128, num_attention_heads=2,
                          kd_target_size=768, **depth),
        teacher_model=ModelConfig(hidden_size=768, num_attention_heads=12,
                                  kd_target_size=128, **depth),
        env=EnvConfig(max_instr_len=200),
        train=TrainConfig(batch_size=PRETRAIN_BATCH, lr=5e-5, optim="adamw"),
        distill=DistillConfig(train_kdl=True, alpha=0.5))


def _finite(what, metrics):
    if not all(math.isfinite(v) for m in metrics for v in m.values()
               if not isinstance(v, str)):
        raise AssertionError(f"{what}: a metric is not finite: {metrics}")


def _simt_launches(what, want):
    """The packed launches since the last reset must number ``want``, all
    on the SIMT route (f32), with no fused launch."""
    from vln_magic_tpu_torch.ops.attention import packed_attention

    got = _launches()
    if (got["packed_attention"] != want or packed_attention.tc_launches
            or got["fused_attention"]):
        raise AssertionError(
            f"{what}: {got} launches ({packed_attention.tc_launches} on "
            f"tensor cores); want {want} packed, all SIMT, 0 fused")
    return got["packed_attention"]


def _time_packed_shapes(calls):
    """For the first captured call of each (B, H, Lq, Lk, sprel): the
    kernel's device time, its bound, the plain version's and
    ``scaled_dot_product_attention``'s on the same tensors, and the calls
    of that shape."""
    import torch.nn.functional as F

    from vln_magic_tpu_torch.ops import attention

    pa, ref = attention.packed_attention, attention.packed_attention_reference
    rows = {}
    for (q, k, v, mask, sp), h, _, _ in calls:
        key = (q.shape[0], h, q.shape[1], k.shape[1], sp is not None)
        if key in rows:
            rows[key]["calls"] += 1
            continue
        b, lq, lk, hd = q.shape[0], q.shape[1], k.shape[1], q.shape[2] // h
        split = lambda x: x.view(b, x.shape[1], h, hd).transpose(1, 2)
        bias = mask[:, None, None, :] + (sp if sp is not None else 0.0)
        bound_ms, bytes_ms, ops_ms = bound(b, h, lq, lk, hd, q.dtype,
                                           sp is not None)
        rows[key] = {
            "B": b, "H": h, "Lq": lq, "Lk": lk, "hd": hd,
            "sprel": sp is not None, "calls": 1,
            "ms": time_ms(lambda: pa(q, k, v, mask, sp, num_heads=h)),
            "plain_ms": time_ms(lambda: ref(q, k, v, mask, sp, h)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                split(q), split(k), split(v), attn_mask=bias)),
            "bound_ms": bound_ms, "bytes_ms": bytes_ms, "ops_ms": ops_ms}
    total = {key: sum(r["calls"] * r[key] for r in rows.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bytes_ms", "ops_ms")}
    return list(rows.values()), total


def phase_pretraining(card, world):
    """Phase 11: the pretraining step at ``bench.py --pretrain``'s shape."""
    from torch.profiler import ProfilerActivity, profile

    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.models.layers import MultiHeadAttention
    from vln_magic_tpu_torch.pretrain.loader import ItemSampler, batch_to_device
    from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer

    cfg = pretrain_config()
    t0 = time.perf_counter()
    tr = PretrainTrainer(cfg, world, device="cuda")
    rng = np.random.default_rng(3)
    items = make_synthetic_instructions(world, 2 * PRETRAIN_BATCH, rng,
                                        min_path=4, max_path=7,
                                        vocab_size=cfg.model.vocab_size)
    for it in items:    # full-length 200-token instructions
        it["instr_encoding"] = rng.integers(4, 1000, 200).astype(np.int32)
    setup_s = time.perf_counter() - t0
    sampler = ItemSampler(items, PRETRAIN_BATCH, 0)
    batches, build_ms = {}, {}
    for task in PRETRAIN_TASKS:
        t0 = time.perf_counter()
        batch = tr._fill(task, getattr(tr.builder, f"{task}_batch")(
            sampler.next_batch()))
        build_ms[task] = (time.perf_counter() - t0) * 1e3
        batches[task] = batch_to_device(batch, "cuda")

    def step(task):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(task, batches[task])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, m

    per_step, step_ms = {}, {}
    for task in PRETRAIN_TASKS:
        warm_ms, _ = step(task)
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        timed = [step(task) for _ in range(PRETRAIN_STEPS)]
        launches = _simt_launches(f"pretraining {task}", PRETRAIN_STEPS
                                  * PRETRAIN_LAUNCHES[task])
        metrics = [m for _, m in timed]
        _finite(f"pretraining {task}", metrics)
        per_step[task] = launches // PRETRAIN_STEPS
        step_ms[task] = float(np.median([ms for ms, _ in timed]))
        emit({"phase": "pretraining_step", "task": task,
              "batch": PRETRAIN_BATCH, "warmup_ms": warm_ms,
              "ms_per_step": [ms for ms, _ in timed],
              "median_ms_per_step": step_ms[task], "metrics": metrics,
              "packed_launches_per_step": per_step[task],
              "route": "simt", "fused_launches": 0,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "host_build_ms_per_batch": build_ms[task], "card": card})

    ratios = {"mlm": 1, "sap": 1, "cfp": 1, "mrc": 1}
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.fit(items, PRETRAIN_FIT, task_ratios=ratios)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    _finite("pretraining fit", hist)
    fit_launches = _simt_launches("pretraining fit", sum(
        PRETRAIN_LAUNCHES[h["task"]] for h in hist))
    emit({"phase": "pretraining_fit", "steps": PRETRAIN_FIT,
          "task_ratios": ratios, "tasks": [h["task"] for h in hist],
          "wall_s": fit_s, "examples_per_s": PRETRAIN_FIT * PRETRAIN_BATCH
          / fit_s, "ms_per_step": fit_s * 1e3 / PRETRAIN_FIT,
          "packed_launches": fit_launches,
          "losses": [h["loss"] for h in hist], "card": card})

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = tr.validate(items, num_batches=1)
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3
    _finite("pretraining validate", [val])
    val_launches = _simt_launches("pretraining validate", sum(
        PRETRAIN_LAUNCHES[t] for t in PRETRAIN_TASKS))
    emit({"phase": "pretraining_validate", "num_batches": 1, "metrics": val,
          "ms": val_ms, "packed_launches": val_launches, "route": "simt",
          "card": card})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms, _ = step("sap")
    emit({"phase": "pretraining_profile", "task": "sap",
          "profiled_ms": profiled_ms,
          **device_breakdown(prof, step_ms["sap"]), "card": card})

    # every packed call of one sap step (the teacher, H 12) and of one
    # validate batch a task (the student, H 2) against the plain version
    _, calls = _captured_packed(lambda: tr.train_step("sap", batches["sap"]))
    step_rows = _check_calls(calls, F32_TOL, tensor_cores=False)
    shapes, per_sap_step = _time_packed_shapes(calls)
    del calls
    _, val_rows = _checked_packed(lambda: tr.validate(items, num_batches=1),
                                  tol=F32_TOL, tensor_cores=False)
    worst = lambda key: max(r[key] for r in step_rows + val_rows)
    emit({"phase": "pretraining_kernel_check", "tol": F32_TOL,
          "sap_step": step_rows, "validate": val_rows,
          "max_abs_err": worst("max_abs_err"),
          "exact_limit_used": worst("exact_limit_used"), "card": card})
    emit({"phase": "pretraining_kernel_times", "dtype": "float32",
          "route": "simt", "teacher_shapes": shapes,
          "per_sap_step": per_sap_step, "card": card})

    # the same sap step with the teacher on its einsum path
    teacher_attn = [m for m in tr.teacher.modules()
                    if isinstance(m, MultiHeadAttention) and m.use_packed]
    for m in teacher_attn:
        m.use_packed = False
    try:
        step("sap")
        _reset_launches()
        einsum = [step("sap") for _ in range(PRETRAIN_STEPS)]
        _simt_launches("pretraining sap, teacher einsum", 0)
    finally:
        for m in teacher_attn:
            m.use_packed = True
    einsum_ms = float(np.median([ms for ms, _ in einsum]))
    emit({"phase": "pretraining_teacher_einsum", "task": "sap",
          "ms_per_step": [ms for ms, _ in einsum],
          "median_ms_per_step": einsum_ms,
          "median_ms_per_step_kernel": step_ms["sap"],
          "kernel_step_share": step_ms["sap"] / einsum_ms, "card": card})
    return {"step": per_step, "validate": val_launches,
            "max_abs_err": worst("max_abs_err"),
            "exact_limit_used": worst("exact_limit_used"),
            "sap_step": per_sap_step}


def golden_pretrain_step(device="cuda"):
    """The port's pretraining step on the golden JAX fixture
    (``PRETRAIN_FIXTURE``): per task, from JAX's weights, the step's
    metrics (loss, kd, accuracies), the student's gradient norm and the
    fixture's leaves after one sgd step.  Returns the errors, and the
    packed launches of each objective as ``launches/<task>``; raises when
    a metric is over 1e-5 (relative, of at least 1e-6), a norm over 1e-4
    relative, or a leaf's update over 1e-4 of its largest."""
    from vln_magic_tpu_torch.config import config_from_dict
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.ops.attention import packed_attention
    from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer
    from vln_magic_tpu_torch.utils.weights import (export_flax_params,
                                                   flax_named_grads,
                                                   load_flax_params)

    fx = dict(np.load(PRETRAIN_FIXTURE))
    spec = json.loads(str(fx["spec"]))
    tree = lambda prefix: {k[len(prefix):]: v for k, v in fx.items()
                           if k.startswith(prefix)}
    tr = PretrainTrainer(config_from_dict(spec["config"]),
                         make_synthetic_world(**spec["world"]),
                         image_prob_size=spec["image_prob_size"],
                         builder_kwargs=spec["builder"], device=device)
    params = tree("params/")
    load_flax_params(tr.teacher, tree("t_params/"))
    errs, bad = {}, []
    for task in spec["tasks"]:
        load_flax_params(tr.model, params)
        batch = tree(f"batch/{task}/")
        tr.opt.zero_grad()
        before = packed_attention.launches
        loss, _ = tr._objective(task, tr._on_device(batch),
                                torch.Generator(device=tr.device)
                                .manual_seed(0))
        errs[f"launches/{task}"] = packed_attention.launches - before
        loss.backward()
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in flax_named_grads(tr.model).values()))
        tr.opt.zero_grad()
        got = tr.train_step(task, batch)
        want = tree(f"metrics/{task}/")
        if sorted(got) != sorted(want):
            bad.append(f"{task} metrics {sorted(got)} != {sorted(want)}")
        for k, w in want.items():
            e = abs(got.get(k, math.nan) - float(w)) / max(abs(float(w)),
                                                          1e-6)
            errs[f"metric_rel/{task}/{k}"] = e
            if not e <= 1e-5:     # "not <=" so that a NaN fails
                bad.append(f"{task} {k}: {got.get(k)} against {float(w)}")
        w = float(fx[f"grad_norm/{task}"])
        errs[f"grad_norm_rel/{task}"] = abs(norm - w) / w
        if not errs[f"grad_norm_rel/{task}"] <= 1e-4:
            bad.append(f"{task} gradient norm {norm} against {w}")
        after = export_flax_params(tr.model)
        for k, w in tree(f"after/{task}/").items():
            step_want = w - params[k]
            e = float(np.max(np.abs(after[k] - w))
                      / np.max(np.abs(step_want)))
            errs[f"leaf_rel/{task}/{k}"] = e
            if not e <= 1e-4:
                bad.append(f"{task} {k}: {e} of its update")
    if bad:
        raise AssertionError("golden pretraining step: " + "; ".join(bad))
    return errs


def phase_golden_pretrain(card):
    """Phase 12: the JAX golden pretraining step in f32, TF32 off, the
    teacher on the packed kernel (SIMT route): 1 launch a mlm objective
    (one language layer), 6 a path task's."""
    _reset_launches()
    errs = golden_pretrain_step()
    launches = {k.split("/")[1]: v for k, v in errs.items()
                if k.startswith("launches/")}
    want = {t: 1 if t == "mlm" else 6 for t in launches}
    if launches != want:
        raise AssertionError(f"golden pretraining: packed launches "
                             f"{launches}, want {want}")
    _simt_launches("golden pretraining", 2 * sum(want.values()))
    emit({"phase": "golden_pretrain", "fixture": os.path.relpath(
        PRETRAIN_FIXTURE, ROOT), "errors": errs,
          "max_metric_rel": max(v for k, v in errs.items()
                                if k.startswith("metric")),
          "max_leaf_rel": max(v for k, v in errs.items()
                              if k.startswith("leaf")),
          "packed_launches_per_objective": launches, "route": "simt",
          "tf32": torch.backends.cuda.matmul.allow_tf32, "card": card})
    return sum(want.values())


# ---- phase 13: the navigation CLI on a dataset tree ---------------------

# R2R's own instruction counts per split (the test split: 1,391 paths x 3)
R2R_SIZES = {"train": 2000, "val_seen": 1021, "val_unseen": 2349,
             "test": 4173}
# what phase 13 writes: R2R's sizes with the cuts that keep the phase near
# four minutes and the script within half its time limit (each cut is
# printed)
CLI_R2R = {"train": 2000, "val_seen": 256, "val_unseen": 256, "test": 256}
CLI_RXR = {"train": 200, "val_unseen": 200}
RXR_LANGS = ("en-US", "en-IN", "hi-IN", "te-IN")
CLI_SCANS, CLI_NODES = 3, 320           # the main path's world size
CLI_SERVE_DECISIONS, CLI_SERVE_EPISODES = 200, 64  # serve CLI, as phase 10
# the shipped scripts' flags (scripts/run_r2r_valid.sh, run_r2r_kdl.sh,
# run_rxr_kdl.sh) without --root_dir/--output_dir and --iters/--log_every
R2R_VALID_FLAGS = ["--dataset", "r2r", "--name", "r2r_magic_s_valid",
                   "--mode", "valid", "--batch_size", "16",
                   "--max_action_len", "15", "--student_hidden_size", "128",
                   "--student_num_attention_heads", "2", "--submit"]
R2R_KDL_FLAGS = [
    "--dataset", "r2r", "--name", "r2r_magic_s", "--mode", "train",
    "--train_alg", "dagger", "--batch_size", "16", "--lr", "4e-5",
    "--ml_weight", "0.2", "--max_action_len", "15", "--max_instr_len", "200",
    "--expert_policy", "spl", "--feat_dropout", "0.4", "--train_kdl",
    "--teacher_hidden_size", "768", "--teacher_num_attention_heads", "12",
    "--student_hidden_size", "128", "--student_num_attention_heads", "2",
    "--kdl_alpha", "0.5", "--kdl_logit_loss", "kd",
    "--kdl_adaptive_ability_weight", "--kdl_adaptive_ability_weight_type",
    "RW", "--teacher_sample_hard_mining", "--t_sample_preprocess", "exp",
    "--t_sample_preprocess_exp_decay", "0.7"]
RXR_KDL_FLAGS = [
    "--dataset", "rxr", "--name", "rxr_magic_s", "--mode", "train",
    "--train_alg", "dagger", "--batch_size", "16", "--lr", "4e-5",
    "--max_action_len", "28", "--max_instr_len", "250",
    "--expert_policy", "ndtw", "--train_kdl", "--teacher_hidden_size", "768",
    "--student_hidden_size", "128", "--student_num_attention_heads", "2"]


def _pose(p):
    """A row-major 4x4 camera pose with the position at 3, 7, 11 (the
    reference's connectivity layout, utils/data.py:95)."""
    m = np.eye(4).ravel().tolist()
    m[3], m[7], m[11] = (float(x) for x in p)
    return m


def write_dataset_tree(root, num_scans, nodes_per_scan, r2r, rxr=None,
                       seed=0, r2r_tokens=200, rxr_tokens=250,
                       vocab_size=50265, hdf5_dim=None):
    """A dataset tree in the reference's layout under ``root``, from a
    synthetic world's graphs: ``R2R/connectivity/<scan>_connectivity.json``
    (poses, ``unobstructed``, ``included``), ``R2R/annotations/
    R2R_<split>_enc.json`` with ``r2r[split]`` instructions (three a path,
    ``r2r_tokens``-token ``instr_encodings``) and, for ``rxr``,
    ``RxR_<split>_guide_enc_xlmr.jsonl`` (one instruction a path of at most
    24 nodes, ``rxr_tokens`` tokens, languages cycling through
    ``RXR_LANGS``); with ``hdf5_dim`` also the CLIP views file
    ``R2R/features/CLIP-ViT-B-16-views.hdf5`` (fp16 [36, hdf5_dim] a
    viewpoint; needs h5py).  Returns the world."""
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    world = make_synthetic_world(num_scans=num_scans,
                                 nodes_per_scan=nodes_per_scan, feat_dim=1,
                                 seed=seed)
    conn = os.path.join(root, "R2R", "connectivity")
    anno = os.path.join(root, "R2R", "annotations")
    os.makedirs(conn, exist_ok=True)
    os.makedirs(anno, exist_ok=True)
    for g in world.graphs:
        with open(os.path.join(conn, f"{g.scan}_connectivity.json"), "w") as f:
            json.dump([{"image_id": vp, "pose": _pose(g.positions[i]),
                        "included": True,
                        "unobstructed": g.adjacency[i].tolist(),
                        "visible": g.adjacency[i].tolist(),
                        "height": float(g.positions[i][2])}
                       for i, vp in enumerate(g.node_ids)], f)
    rng = np.random.default_rng(seed)
    enc = lambda n: [0] + rng.integers(4, vocab_size, n - 2).tolist() + [2]
    for s, (split, n) in enumerate(r2r.items()):
        paths = make_synthetic_instructions(world, -(-n // 3), rng,
                                            min_path=3, max_path=6)
        data = []
        for k, it in enumerate(paths):
            m = min(3, n - 3 * k)
            data.append({"path_id": 10000 * s + k, "scan": it["scan"],
                         "path": it["path"], "heading": it["heading"],
                         "instructions": [it["instruction"]] * m,
                         "instr_encodings": [enc(r2r_tokens)
                                             for _ in range(m)]})
        with open(os.path.join(anno, f"R2R_{split}_enc.json"), "w") as f:
            json.dump(data, f)
    for split, n in (rxr or {}).items():
        paths = make_synthetic_instructions(world, n, rng, min_path=4,
                                            max_path=23)
        with open(os.path.join(anno, f"RxR_{split}_guide_enc_xlmr.jsonl"),
                  "w") as f:
            for k, it in enumerate(paths):
                f.write(json.dumps({
                    "instruction_id": 50000 + k, "path_id": 90000 + k,
                    "scan": it["scan"], "path": it["path"],
                    "heading": it["heading"],
                    "instruction": it["instruction"],
                    "language": RXR_LANGS[k % len(RXR_LANGS)],
                    "instr_encoding": enc(rxr_tokens)}) + "\n")
    if hdf5_dim:
        from vln_magic_tpu_torch.data.features import write_hdf5_features

        feat_dir = os.path.join(root, "R2R", "features")
        os.makedirs(feat_dir, exist_ok=True)
        write_hdf5_features(
            os.path.join(feat_dir, "CLIP-ViT-B-16-views.hdf5"),
            {f"{g.scan}_{vp}": rng.standard_normal((36, hdf5_dim))
             for g in world.graphs for vp in g.node_ids})
    return world


def observation_message(obs):
    """An ``Observation`` as the serve protocol's JSON message, features in
    base64 f32."""
    return {"type": "observation", "node": obs.node,
            "position": [float(x) for x in obs.position],
            "heading": float(obs.heading),
            "pano_feats": base64.b64encode(np.ascontiguousarray(
                obs.pano_feats, np.float32).tobytes()).decode(),
            "candidates": [{"node": c.node,
                            "position": [float(x) for x in c.position],
                            "dist": c.dist, "heading": c.heading,
                            "elevation": c.elevation, "view": c.view}
                           for c in obs.candidates]}


def same_predictions(what, got, want, tol):
    """Equal instruction ids and trajectories; the ``details`` stop
    probabilities within ``tol``."""
    if [p["instr_id"] for p in got] != [p["instr_id"] for p in want]:
        raise AssertionError(f"{what}: other instructions")
    for a, b in zip(got, want):
        if a["trajectory"] != b["trajectory"]:
            raise AssertionError(f"{what} {a['instr_id']}: trajectory "
                                 f"{a['trajectory']} != {b['trajectory']}")
        da, db = a.get("details", {}), b.get("details", {})
        if sorted(da) != sorted(db) or any(
                abs(da[k]["stop_prob"] - db[k]["stop_prob"]) > tol
                for k in da):
            raise AssertionError(f"{what} {a['instr_id']}: details differ")


@contextlib.contextmanager
def _recorded(owner, name):
    """Wrap ``owner.name`` so that each call appends (synchronised wall
    seconds, positional arguments, the result) to the yielded list."""
    orig = getattr(owner, name)
    calls = []

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, args, out))
        return out

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def _cli(argv):
    """The port's ``main_nav`` in this process with the kernel counts set
    to 0 just before and read just after; no kernel may launch (no flag
    sets ``use_pallas_attention``, as in JAX): (result, wall seconds, peak
    device bytes, launches)."""
    from vln_magic_tpu_torch.cli.main_nav import main as cli_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    out = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"main_nav {argv[:6]}: kernel launches "
                             f"{launches}, want 0")
    return out, wall, torch.cuda.max_memory_allocated(), launches


def _finite_metrics(what, results):
    for split, avg in results.items():
        bad = {k: v for k, v in avg.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{what} {split}: {bad}")


def _cli_valid(card, root, out):
    """Phase 13 (a): ``run_r2r_valid.sh``'s flags plus ``--test`` and
    ``--detailed_output`` from a ``.pt`` of seeded MAGIC-S weights; the
    val_seen predictions equal ``Navigator.evaluate`` called directly."""
    from vln_magic_tpu_torch.agent.evaluator import submission_format
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.cli.main_nav import (build_config, build_dataset,
                                                  feature_store, parse_args)
    from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
    from vln_magic_tpu_torch.utils.checkpoint import (
        restore_reference_checkpoint, save_reference_checkpoint)
    from vln_magic_tpu_torch.utils.weights import init_params

    argv = R2R_VALID_FLAGS + ["--root_dir", root, "--output_dir", out,
                              "--test", "--detailed_output"]
    args = parse_args(argv)
    cfg = build_config(args)
    store = type(feature_store(args, cfg.model.image_feat_size)).__name__
    model = DualScaleVLNBert(cfg.model, device="cuda")
    init_params(model, 0)
    pt = os.path.join(out, "magic_s_seed0.pt")
    save_reference_checkpoint(model, pt, epoch=3)
    del model
    argv += ["--resume_file", pt]
    from vln_magic_tpu_torch.agent import navigator as nav_mod

    with _recorded(nav_mod.Navigator, "evaluate") as calls:
        results, wall, peak, launches = _cli(argv)
    _finite_metrics("cli valid", results)
    pred_dir = parse_args(argv).pred_dir
    splits, order = {}, ("val_seen", "val_unseen", "test")
    if [len(c[1][1]) for c in calls] != [CLI_R2R[s] for s in order]:
        raise AssertionError(f"cli valid evaluated {len(calls)} splits")
    for split, (dt, (_, items), (_, preds)) in zip(order, calls):
        splits[split] = {"items": len(items), "s": dt,
                         "items_per_s": len(items) / dt}
        with open(os.path.join(pred_dir, f"submit_{split}.json")) as f:
            if json.load(f) != json.loads(json.dumps(
                    submission_format(preds))):
                raise AssertionError(f"submit_{split}.json differs from "
                                     "the evaluated predictions")
        if not all("details" in p for p in preds):
            raise AssertionError("--detailed_output: a prediction has no "
                                 "details")
    # the same world and weights through Navigator.evaluate directly
    world, items = build_dataset(args, cfg)
    nav = Navigator(cfg, world, device="cuda")
    restore_reference_checkpoint(nav.model, pt)
    (_, _), direct = nav.evaluate(items["val_seen"], detailed_output=True)
    same_predictions("cli valid val_seen", calls[0][2][1], direct, 1e-6)
    emit({"phase": "cli_valid", "flags": "scripts/run_r2r_valid.sh + --test "
          "--detailed_output --resume_file", "feature_store": store,
          "wall_s": wall, "splits": splits, "metrics": results,
          "val_seen_equals_navigator": True, "peak_bytes": peak,
          "kernels": launches, "card": card})
    return pt, launches


def _cli_valid_streamed(card, root, out, pt):
    """Phase 13 (a'): ``run_r2r_valid.sh``'s own flags from the same
    ``.pt``; without ``--detailed_output`` each split streams
    (``shard_items``, the streamed ``evaluate``, ``gather_predictions``):
    the submission files equal the evaluated predictions, and val_unseen's
    predictions equal ``Navigator.evaluate`` called directly."""
    from vln_magic_tpu_torch.agent import navigator as nav_mod
    from vln_magic_tpu_torch.agent.evaluator import submission_format
    from vln_magic_tpu_torch.cli.main_nav import (build_config, build_dataset,
                                                  parse_args)
    from vln_magic_tpu_torch.utils.checkpoint import (
        restore_reference_checkpoint)

    argv = R2R_VALID_FLAGS + ["--root_dir", root, "--output_dir",
                              os.path.join(out, "streamed"),
                              "--resume_file", pt]
    with _recorded(nav_mod.Navigator, "evaluate") as calls, \
            _recorded(nav_mod.Navigator, "_evaluate_stream") as streamed:
        results, wall, peak, launches = _cli(argv)
    _finite_metrics("cli valid streamed", results)
    if len(streamed) != len(calls) or not calls:
        raise AssertionError(f"cli valid: {len(streamed)} of {len(calls)} "
                             "splits streamed")
    args = parse_args(argv)
    splits, order = {}, ("val_seen", "val_unseen", "test")   # --submit: test
    if [len(c[1][1]) for c in calls] != [CLI_R2R[s] for s in order]:
        raise AssertionError(f"cli valid streamed evaluated {len(calls)} "
                             "splits")
    for split, (dt, (_, items), (_, preds)) in zip(order, calls):
        splits[split] = {"items": len(items), "s": dt,
                         "items_per_s": len(items) / dt}
        with open(os.path.join(args.pred_dir, f"submit_{split}.json")) as f:
            if json.load(f) != json.loads(json.dumps(
                    submission_format(preds))):
                raise AssertionError(f"streamed submit_{split}.json differs "
                                     "from the evaluated predictions")
    unseen = calls[1][2][1]
    cfg = build_config(args)
    world, items = build_dataset(args, cfg)
    nav = nav_mod.Navigator(cfg, world, device="cuda")
    restore_reference_checkpoint(nav.model, pt)
    (_, _), direct = nav.evaluate(items["val_unseen"])
    same_predictions("cli valid streamed val_unseen", unseen, direct, 0.0)
    emit({"phase": "cli_valid_streamed", "flags": "scripts/run_r2r_valid.sh "
          "+ --resume_file", "wall_s": wall, "splits": splits,
          "metrics": results, "val_unseen_equals_navigator": True,
          "peak_bytes": peak, "kernels": launches, "card": card})
    return launches


def _cli_train(card, root, out):
    """Phase 13 (b): ``run_r2r_kdl.sh``'s flags, two iterations, then
    ``--auto_resume`` to four."""
    from vln_magic_tpu_torch.agent.trainer import Trainer
    from vln_magic_tpu_torch.cli.main_nav import parse_args

    argv = R2R_KDL_FLAGS + ["--root_dir", root, "--output_dir", out,
                            "--log_every", "2", "--for_debug"]
    runs = []
    for extra in (["--iters", "2"], ["--iters", "4", "--auto_resume"]):
        with _recorded(Trainer, "train_step") as steps:
            trainer, wall, peak, launches = _cli(argv + extra)
        runs.append({"iters": extra[1], "wall_s": wall,
                     "ms_per_iteration": [1e3 * s[0] for s in steps],
                     "peak_bytes": peak, "metrics": steps[-1][2]})
        _finite_metrics("cli train", {"step": steps[-1][2]})
    if trainer.iteration != 4:
        raise AssertionError(f"--auto_resume reached iteration "
                             f"{trainer.iteration}, want 4")
    a = parse_args(argv + ["--iters", "4"])
    files = {d: sorted(os.listdir(d)) for d in (a.ckpt_dir, a.log_dir)}
    need = {a.ckpt_dir: {"best_val_seen.pt", "best_val_unseen.pt",
                         "latest_dict.pt", "train_state"},
            a.log_dir: {"training_args.json", "metrics.jsonl", "train.txt"}}
    for d, names in need.items():
        if not names <= set(files[d]):
            raise AssertionError(f"cli train: {d} holds {files[d]}")
    with open(os.path.join(a.log_dir, "train.txt")) as f:
        record = f.read()
    if "auto-resumed train state at iter 2" not in record:
        raise AssertionError("cli train: --auto_resume did not resume at 2")
    with open(os.path.join(a.log_dir, "metrics.jsonl")) as f:
        for line in f:
            if not all(math.isfinite(v) for v in json.loads(line).values()):
                raise AssertionError(f"cli train: metrics {line}")
    emit({"phase": "cli_train", "flags": "scripts/run_r2r_kdl.sh + --iters "
          "2 --log_every 2 --for_debug, then --iters 4 --auto_resume",
          "compute": "float32, TF32 off", "runs": runs,
          "kernels": launches, "card": card})
    return launches


def _cli_train_ndtw(card, root, out):
    """Phase 13 (c): ``run_rxr_kdl.sh``'s flags, one iteration; on one
    DAgger state of it, the nDTW scores and the expert's actions on the
    card against the same call on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from vln_magic_tpu_torch.agent.rollout import Rollout
    from vln_magic_tpu_torch.agent.trainer import Trainer

    argv = RXR_KDL_FLAGS + ["--root_dir", root, "--output_dir", out,
                            "--iters", "1", "--log_every", "1",
                            "--for_debug"]
    grabbed = []
    orig = Rollout.teacher_action

    def grab(self, state, gmap, t_step, imitation, ep):
        if not imitation and t_step == 8 and not grabbed:
            clone = lambda d: {k: v.clone() for k, v in d.items()
                               if torch.is_tensor(v)}
            grabbed.append((self, dataclasses.replace(state, **{
                f.name: getattr(state, f.name).clone()
                for f in dataclasses.fields(state)
                if getattr(state, f.name) is not None}), clone(gmap),
                clone(ep)))
        return orig(self, state, gmap, t_step, imitation, ep)

    Rollout.teacher_action = grab
    try:
        with _recorded(Trainer, "train_step") as steps:
            trainer, wall, peak, launches = _cli(argv)
    finally:
        Rollout.teacher_action = orig
    if not grabbed:
        raise AssertionError("cli train ndtw: no DAgger expert call at step 8")
    r, state, gmap, ep = grabbed[0]
    if int(state.traj_len.max()) <= 1:
        raise AssertionError("cli train ndtw: the trajectory was not recorded")
    scores = r._ndtw_scores(state, gmap, ep)
    actions = r.teacher_action(state, gmap, 8, False, ep)
    counts = {}
    for name, fn in (("ndtw_scores", lambda: r._ndtw_scores(state, gmap, ep)),
                     ("expert_action", lambda: r.teacher_action(
                         state, gmap, 8, False, ep))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts[name] = sum(1 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    rc = copy.copy(r)
    rc.t = dataclasses.replace(r.t, **{
        f.name: getattr(r.t, f.name).cpu() for f in dataclasses.fields(r.t)
        if getattr(r.t, f.name) is not None})
    sc = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).cpu()
        for f in dataclasses.fields(state)
        if getattr(state, f.name) is not None})
    ref_scores = rc._ndtw_scores(sc, cpu(gmap), cpu(ep))
    ref_actions = rc.teacher_action(sc, cpu(gmap), 8, False, cpu(ep))
    err = float((scores.cpu() - ref_scores).abs().max())
    if err > 1e-5 or not torch.equal(actions.cpu(), ref_actions):
        raise AssertionError(f"nDTW on the card: {err} from the CPU's, "
                             f"actions equal: "
                             f"{torch.equal(actions.cpu(), ref_actions)}")
    emit({"phase": "cli_train_ndtw", "flags": "scripts/run_rxr_kdl.sh + "
          "--iters 1 --log_every 1 --for_debug", "T": 28, "wall_s": wall,
          "ms_per_step": [1e3 * s[0] for s in steps], "peak_bytes": peak,
          "metrics": steps[-1][2], "ndtw_max_abs_err_vs_cpu": err,
          "expert_actions_equal_cpu": True, "device_events_per_call": counts,
          "scores_shape": list(scores.shape), "kernels": launches,
          "card": card})
    return launches


class _ServeRobot:
    """The serve protocol's client as the CLI's stdin: it replays a script
    of episodes recorded from an in-process session, one line after the
    CLI has answered the one before, and holds every answer (read from
    ``out``, the CLI's stdout) to the script: decisions, the save and
    restore after ``save_at``'s first decision, each final trajectory."""

    def __init__(self, script, save_at, blob):
        self.script, self.save_at, self.blob = script, save_at, blob
        self.out = io.StringIO()
        self.latency, self.first_read = [], None

    def _reply(self, want_type):
        lines = self.out.getvalue().splitlines()
        msg = json.loads(lines[-1]) if lines else {}
        if msg.get("type") != want_type:
            raise AssertionError(f"serve CLI: {msg}, want {want_type}")
        return msg

    def __iter__(self):
        self.first_read = time.perf_counter()
        self._reply("loaded")
        for e, (instr, steps, trajectory) in enumerate(self.script):
            yield json.dumps({"type": "session", "instruction": instr})
            self._reply("ready")
            for k, (obs, want) in enumerate(steps):
                yield json.dumps(observation_message(obs))
                got = self._reply("decision")
                if (got["stop"], got["target"], got["path"]) != \
                        (want.stop, want.target, want.path):
                    raise AssertionError(f"serve CLI episode {e} step {k}: "
                                         f"{got}, in-process {want}")
                self.latency.append(got["latency_ms"])
                if (e, k) == self.save_at:
                    yield json.dumps({"type": "save", "path": self.blob})
                    saved = self._reply("saved")
                    yield json.dumps({"type": "restore", "path": self.blob})
                    resumed = self._reply("ready")
                    if saved["steps"] != k + 1 or resumed["steps"] != k + 1:
                        raise AssertionError(f"serve CLI: {saved} {resumed}")
            yield json.dumps({"type": "finish"})
            if self._reply("final")["trajectory"] != trajectory:
                raise AssertionError(f"serve CLI episode {e}: final "
                                     f"{self.out.getvalue().splitlines()[-1]}"
                                     f", in-process {trajectory}")
        yield json.dumps({"type": "quit"})


def _cli_serve(card, pt, out):
    """Phase 13 (d): ``--mode serve`` in this process, its stdin a scripted
    robot and its stdout read back.  An in-process ``NavServer`` session on
    the same weights first runs episodes on one 64-node scan until
    ``CLI_SERVE_DECISIONS`` decisions and records each observation and
    decision; the CLI then gets the same observations, the first episode
    that moves saved and restored after its first decision, and must give
    every decision again.  The kernel counts are the CLI's own run's."""
    from vln_magic_tpu_torch.agent.serving import (NavServer,
                                                   observation_from_world)
    from vln_magic_tpu_torch.cli.main_nav import build_config, parse_args
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.models.vlnbert import DualScaleVLNBert
    from vln_magic_tpu_torch.utils.checkpoint import (
        restore_reference_checkpoint)

    world = make_synthetic_world(num_scans=1, nodes_per_scan=SERVE_NODES,
                                 feat_dim=768, seed=0)
    g = world.graphs[0]
    c = world.tables.max_candidates
    rng = np.random.default_rng(11)
    items = make_synthetic_instructions(world, CLI_SERVE_EPISODES, rng,
                                        min_path=4, max_path=7)
    argv = ["--mode", "serve", "--name", "serve", "--output_dir", out,
            "--student_hidden_size", "128", "--student_num_attention_heads",
            "2", "--serve_max_nodes", str(SERVE_NODES),
            "--serve_max_cands", str(c), "--resume_file", pt]
    cfg = build_config(parse_args(argv))
    model = DualScaleVLNBert(cfg.model, device="cuda")
    restore_reference_checkpoint(model, pt)
    server = NavServer(cfg, max_nodes=SERVE_NODES, max_cands=c, model=model,
                       device="cuda")
    server.warmup()
    script, in_process, save_at = [], [], None
    for item in items:
        instr = rng.integers(4, 1000, 200).tolist()
        sess = server.new_session(np.asarray(instr, np.int64))
        cur, steps = int(item["path_idx"][0]), []
        for _ in range(cfg.env.max_action_len):
            obs = observation_from_world(world, 0, cur, float(item["heading"]))
            dec = sess.step(obs)
            steps.append((obs, dec))
            in_process.append(dec.latency_ms)
            if dec.stop:
                break
            cur = g.index[dec.target]
        if save_at is None and len(steps) > 1:
            save_at = (len(script), 0)
        script.append((instr, steps, sess.finish()["trajectory"]))
        if len(in_process) >= CLI_SERVE_DECISIONS and save_at:
            break
    if save_at is None or len(in_process) < CLI_SERVE_DECISIONS:
        raise AssertionError(f"serve: {len(in_process)} decisions in "
                             f"{len(script)} episodes, save at {save_at}")
    del server, model, sess
    robot = _ServeRobot(script, save_at,
                        os.path.join(out, "serve_session.npz"))
    stdin = sys.stdin
    sys.stdin = robot
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(robot.out):
            _, wall, peak, launches = _cli(argv)
    finally:
        sys.stdin = stdin
    if len(robot.latency) != len(in_process):
        raise AssertionError(f"serve CLI: {len(robot.latency)} decisions, "
                             f"want {len(in_process)}")
    emit({"phase": "cli_serve", "nodes": SERVE_NODES, "max_cands": c,
          "episodes": len(script),
          "steps_per_episode": [len(s[1]) for s in script],
          "latency_ms": _stats(robot.latency),
          "in_process_latency_ms": _stats(in_process),
          "startup_s": robot.first_read - t0, "wall_s": wall,
          "peak_bytes": peak, "equal_in_process": True,
          "save_restore_at": {"episode": save_at[0], "after_decision": 1},
          "kernels": launches, "card": card})
    return launches


def phase_cli(card, then=None):
    """Phase 13: the port's ``main_nav`` with JAX's flags on a dataset tree
    in the reference's layout (3 scans x 320 viewpoints, no HDF5 file:
    the hash feature store at CLIP width 768): (a) valid with
    ``--detailed_output`` (waves) and (a') without it (streamed), (b)
    train, (c) train with the nDTW expert, (d) serve.  Returns the launches of each
    run, all 0, and what ``then(root, out, pt)`` returns: the later phases
    that run on the same tree (phase 14 (e)), before it is removed."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        root, out = os.path.join(tmp, "datasets"), os.path.join(tmp, "runs")
        t0 = time.perf_counter()
        write_dataset_tree(root, CLI_SCANS, CLI_NODES, CLI_R2R, CLI_RXR)
        emit({"phase": "cli_tree", "scans": CLI_SCANS,
              "viewpoints_per_scan": CLI_NODES, "r2r": CLI_R2R,
              "rxr": CLI_RXR, "rxr_langs": RXR_LANGS,
              "cuts": {s: f"{n} of R2R's {R2R_SIZES[s]}"
                       for s, n in CLI_R2R.items() if n != R2R_SIZES[s]},
              "train_runs": "--for_debug: 50 annotation items a split",
              "write_s": time.perf_counter() - t0})
        pt, valid = _cli_valid(card, root, out)
        streamed = _cli_valid_streamed(card, root, out, pt)
        train = _cli_train(card, root, out)
        ndtw = _cli_train_ndtw(card, root, out)
        serve = _cli_serve(card, pt, out)
        later = then(root, out, pt) if then else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"cli_valid": valid, "cli_valid_streamed": streamed,
            "cli_train": train, "cli_train_ndtw": ndtw,
            "cli_serve": serve}, later


# ---- phase 14: interventions, the branch-fused trunk, MC ensembles -------

HEADS = {"do_back_txt": True, "do_back_img": True, "do_front_txt": True,
         "do_front_img": True, "do_front_his": True}
HEAD_FLAGS = ["--do_back_txt", "--do_front_txt", "--do_front_img",
              "--do_front_his"]
# the packed kernel's launches a wave at T 15 with fuse_branches: 6
# language, then 2 panorama + 3 layers x (cross + self) at batch 2B a step
FUSED_LAUNCHES_PER_WAVE = 6 + 15 * (2 + 3 * 2)                      # 126
ENSEMBLE_N = 3
WALL_ROUNDS = 4          # interleaved timed rounds of phase 14's four waves


def golden_fused_decode(device="cuda"):
    """``tests/fixtures/golden_params_777.npz`` decoded with
    ``fuse_branches`` in f32 (the packed kernel's SIMT route on the card):
    the trajectories must be ``tests/golden_decode.json``'s."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.ops.attention import packed_attention

    world = make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                 seed=777)
    flat = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                     "golden_params_777.npz")))
    items = make_synthetic_instructions(world, 8, np.random.default_rng(777),
                                        vocab_size=400, min_path=3,
                                        max_path=6)
    cfg = golden_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fuse_branches=True))
    nav = Navigator(cfg, world, params=flat, device=device)
    packed_attention.launches = packed_attention.tc_launches = 0
    (_, _), preds = nav.evaluate(items, batch_size=8)
    with open(os.path.join(ROOT, "tests", "golden_decode.json")) as f:
        want = json.load(f)
    got = [p["trajectory_idx"] for p in preds]
    if got != want:
        raise AssertionError(f"fused-branch golden decode: {got} != {want}")
    return {"match": True, "kernel_launches": packed_attention.launches,
            "tc_launches": packed_attention.tc_launches}


def fused_branch_kernel_check(batch=8, t_steps=3):
    """Every ``packed_attention`` call of a bf16 fused-branch decode at a
    small width (MAGIC-S's heads, 3 layers, T ``t_steps``) held against the
    plain version (``_checked_packed``), on the tensor-core route."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    cfg = main_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_feat_size=64,
                                       fuse_branches=True),
        env=dataclasses.replace(cfg.env, max_action_len=t_steps,
                                max_gmap_len=32, max_instr_len=48),
        train=dataclasses.replace(cfg.train, batch_size=batch))
    world = make_synthetic_world(num_scans=1, nodes_per_scan=40, feat_dim=64,
                                 seed=3)
    items = make_synthetic_instructions(world, batch,
                                        np.random.default_rng(3),
                                        vocab_size=500, min_path=3,
                                        max_path=6)
    nav = Navigator(cfg, world, seed=1, device="cuda")
    _, rows = _checked_packed(lambda: nav.evaluate(items))
    return rows


def full_width_zdicts(mcfg, seed=0):
    """Seeded intervention dictionaries at ``mcfg``'s widths, in the CLI's
    layout: 81-row backdoor tables (30 direction and 60 landmark words,
    the rest padding at p 0), 24 frontdoor exemplars a family (the
    default ``--front_n_clusters``) and a 24-row image backdoor."""
    from vln_magic_tpu_torch.agent.interventions import (Zdict,
                                                         build_rollout_zdicts)

    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    d = mcfg.hidden_size
    front = mcfg.kd_target_size if mcfg.kd_heads else d
    back = {k: Zdict(f(n, d), rng.random(n) + 0.1)
            for k, n in (("direction", 30), ("landmark", 60))}
    z = build_rollout_zdicts(back, {k: f(24, front)
                                    for k in ("txt", "vp", "gmap")},
                             pad_entries=81)
    img_p = rng.random((24, 1)).astype(np.float32)
    z.update(z_img_feats=f(24, mcfg.image_feat_size),
             z_img_pzs=img_p / img_p.sum())
    return z


def _profiled_wave(nav, items, **kw):
    """One ``evaluate`` under ``torch.profiler``: its device breakdown over
    the synchronised wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nav.evaluate(items, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"profiled_wall_ms": wall_ms,
            **device_breakdown(prof, wall_ms, top=5)}


def phase_model_options(card, nav, items):
    """Phase 14 (a)-(d) at the main path's shape (phase 4's navigator,
    world and 256 items): (a) a ``fuse_branches`` wave, bf16, the same
    weights: 126 launches, every packed call held to the plain version,
    device time and idle share beside an unfused wave's, the
    trajectories' agreement; (b) the golden decodes in f32 (SIMT); (c) a
    wave with all five intervention heads and seeded dictionaries: 216
    launches; (d) an ``ensemble_n`` 3 wave: 6 launches.  The walls of the
    four waves are taken in ``WALL_ROUNDS`` interleaved rounds (the host's
    pace drifts within a call).  Returns the launches and checks."""
    from vln_magic_tpu_torch.agent import interventions as I
    from vln_magic_tpu_torch.agent.navigator import Navigator

    cfg = nav.cfg
    out = {}
    with_model = lambda **kw: Navigator(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **kw)), nav.world, seed=0,
        device="cuda")
    fnav, hnav = with_model(fuse_branches=True), with_model(**HEADS)
    zd = {"student": full_width_zdicts(hnav.cfg.model)}
    waves = {"unfused": (nav, {}), "fused": (fnav, {}),
             "interventions": (hnav, {"zdicts": zd}),
             "ensemble": (nav, {"ensemble_n": ENSEMBLE_N})}
    want = {"unfused": LAUNCHES_PER_WAVE, "fused": FUSED_LAUNCHES_PER_WAVE,
            "interventions": LAUNCHES_PER_WAVE, "ensemble": 6}
    runs = {}
    for name, (n, kw) in waves.items():
        n.evaluate(items, **kw)                                 # warm-up
        avg, preds, wall, launches = timed_evaluate(n, items, **kw)
        if launches["packed_attention"] != want[name]:
            raise AssertionError(f"{name} wave launched {launches}, want "
                                 f"{want[name]}")
        check_tensor_cores(f"{name} wave", launches)
        check_decode(nav.world, items, avg, preds)
        runs[name] = {"avg": avg, "preds": preds, "walls": [wall],
                      "launches": launches}
    for r in range(WALL_ROUNDS):
        for name in (list(waves) if r % 2 else list(waves)[::-1]):
            n, kw = waves[name]
            runs[name]["walls"].append(timed_evaluate(n, items, **kw)[2])
    wall = {k: float(np.median(v["walls"])) for k, v in runs.items()}
    walls = {k: v["walls"] for k, v in runs.items()}
    # (a) the branch-fused trunk
    f, u = runs["fused"], runs["unfused"]
    same = float(np.mean([a["trajectory"] == b["trajectory"]
                          for a, b in zip(f["preds"], u["preds"])]))
    _, rows = _checked_packed(lambda: fnav.evaluate(items))
    profiles = {"fused": _profiled_wave(fnav, items),
                "unfused": _profiled_wave(nav, items)}
    emit({"phase": "fused_branches_wave", "batch": MAIN_BATCH, "T": MAIN_T,
          "wall_s": wall["fused"], "unfused_wall_s": wall["unfused"],
          "walls_s": walls["fused"], "unfused_walls_s": walls["unfused"],
          "semantic_steps_per_s": f["avg"]["semantic_steps"] / wall["fused"],
          "unfused_semantic_steps_per_s":
              u["avg"]["semantic_steps"] / wall["unfused"],
          "kernels": f["launches"], "unfused_kernels": u["launches"],
          "trajectories_equal_share": same, "kernel_check": rows,
          "profiles": profiles, "metrics": f["avg"], "card": card})
    out["fused_wave"] = f["launches"]["packed_attention"]
    out["fused_max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["fused_exact_limit_used"] = max(r["exact_limit_used"] for r in rows)
    del fnav
    # (b) the golden decodes, f32
    g_int = golden_interventions("cuda")
    g_fused = golden_fused_decode("cuda")
    if g_int["tc_launches"] or g_fused["tc_launches"]:
        raise AssertionError("an f32 golden call took the tensor-core route")
    emit({"phase": "golden_model_options", "interventions": g_int,
          "fused_branches": g_fused, "route": "simt", "card": card})
    out["interventions_golden_f32"] = g_int["kernel_launches"]
    out["fused_golden_f32"] = g_fused["kernel_launches"]
    # (c) all five heads; (d) MC dropout: panorama and navigation draw
    # dropout, so only the deterministic language encoder takes the kernel
    for name, extra in (("interventions", {
            "heads": sorted(HEADS), "dict_rows": {
                k: list(np.shape(v))
                for k, v in I.flat_zdicts(zd["student"]).items()}}),
            ("ensemble", {"ensemble_n": ENSEMBLE_N})):
        run = runs[name]
        emit({"phase": f"{name}_wave", **extra, "batch": MAIN_BATCH,
              "T": MAIN_T, "wall_s": wall[name], "walls_s": walls[name],
              "unfused_wall_s": wall["unfused"],
              "semantic_steps_per_s":
                  run["avg"]["semantic_steps"] / wall[name],
              "kernels": run["launches"], "metrics": run["avg"],
              "card": card})
        out[f"{name}_wave"] = run["launches"]["packed_attention"]
    return out


def _with_mode(flags, mode):
    i = flags.index("--mode")
    return flags[:i + 1] + [mode] + flags[i + 2:]


def phase_cli_interventions(card, root, out, pt):
    """Phase 14 (e), on phase 13's tree with its MAGIC-S ``.pt``, each run
    in this process with the kernel counts read over it (0, as in JAX):
    ``--mode extract_cfp_features``; the intervention ``valid`` (every
    text, view and map head, the dictionaries rebuilt on the 2,000-item
    train split: language, CFP and k-means timed apart); ``train`` with
    ``--z_instr_update --update_iter 1`` for 2 iterations (both roles
    refreshed each); ``valid --ensemble_n 3``."""
    from vln_magic_tpu_torch.agent import interventions as I
    from vln_magic_tpu_torch.agent.trainer import Trainer
    from vln_magic_tpu_torch.cli.main_nav import build_config, parse_args

    where = ["--root_dir", root, "--output_dir", out]
    launches = {}
    # extract_cfp_features
    argv = _with_mode(R2R_VALID_FLAGS, "extract_cfp_features") + where + [
        "--resume_file", pt]
    m = build_config(parse_args(argv)).model
    width = m.kd_target_size if m.kd_heads else m.hidden_size
    path, wall, peak, launches["cli_extract_cfp"] = _cli(argv)
    feats, ids = I.load_cfp_tsv(path, width)
    if len(ids) != CLI_R2R["train"] or not all(
            np.isfinite(v).all() and v.shape[1] == width
            for v in feats.values()):
        raise AssertionError(f"extract_cfp_features: {len(ids)} rows")
    emit({"phase": "cli_extract_cfp", "rows": len(ids), "wall_s": wall,
          "rows_per_s": len(ids) / wall, "peak_bytes": peak,
          "kernels": launches["cli_extract_cfp"], "card": card})
    # valid with the interventions, dictionaries rebuilt on the train split
    argv = R2R_VALID_FLAGS + HEAD_FLAGS + where + [
        "--resume_file", pt, "--name", "r2r_magic_s_interventions"]
    with _recorded(I, "update_backdoor_dict") as lang, \
            _recorded(I, "extract_cfp_features") as cfp, \
            _recorded(I, "KMeansPicker") as km:
        results, wall, peak, launches["cli_valid_interventions"] = _cli(argv)
    _finite_metrics("cli valid interventions", results)
    if not (len(lang) == len(cfp) == len(km) == 1):
        raise AssertionError("cli valid interventions: the refresh ran "
                             f"{len(lang)}, {len(cfp)}, {len(km)} times")
    emit({"phase": "cli_valid_interventions",
          "flags": "scripts/run_r2r_valid.sh + " + " ".join(HEAD_FLAGS),
          "train_items": CLI_R2R["train"], "wall_s": wall,
          "refresh_s": {"language": lang[0][0], "cfp": cfp[0][0],
                        "kmeans": km[0][0]},
          "metrics": results, "peak_bytes": peak,
          "kernels": launches["cli_valid_interventions"], "card": card})
    # train with the refresh every iteration
    argv = R2R_KDL_FLAGS + HEAD_FLAGS + where + [
        "--z_instr_update", "--update_iter", "1", "--iters", "2",
        "--log_every", "1", "--for_debug",
        "--name", "r2r_magic_s_interventions"]
    with _recorded(Trainer, "train_step") as steps, \
            _recorded(I, "extract_cfp_features") as cfp:
        trainer, wall, peak, launches["cli_train_interventions"] = _cli(argv)
    a = parse_args(argv)
    tsvs = sorted(f for f in os.listdir(a.ckpt_dir)
                  if f.startswith("cfp_features_"))
    want = {f"cfp_features_{r}_{i}.tsv" for r in ("student", "teacher")
            for i in range(3)}
    if not want <= set(tsvs) or sorted(trainer.zdicts) != ["student",
                                                            "teacher"]:
        raise AssertionError(f"cli train interventions: {tsvs}, "
                             f"{sorted(trainer.zdicts)}")
    _finite_metrics("cli train interventions", {"step": steps[-1][2]})
    emit({"phase": "cli_train_interventions",
          "flags": "scripts/run_r2r_kdl.sh + " + " ".join(HEAD_FLAGS)
                   + " --z_instr_update --update_iter 1 --iters 2 "
                     "--for_debug",
          "wall_s": wall, "ms_per_iteration": [1e3 * s[0] for s in steps],
          "cfp_refresh_s": [c[0] for c in cfp], "cfp_tsvs": tsvs,
          "peak_bytes": peak, "kernels": launches["cli_train_interventions"],
          "card": card})
    # MC-dropout ensemble validation
    argv = [f for f in R2R_VALID_FLAGS if f != "--submit"] + where + [
        "--resume_file", pt, "--ensemble_n", str(ENSEMBLE_N), "--for_debug",
        "--name", "r2r_magic_s_ensemble"]
    results, wall, peak, launches["cli_valid_ensemble"] = _cli(argv)
    _finite_metrics("cli valid ensemble", results)
    emit({"phase": "cli_valid_ensemble",
          "flags": f"scripts/run_r2r_valid.sh without --submit + "
                   f"--ensemble_n {ENSEMBLE_N} --for_debug",
          "wall_s": wall, "metrics": results,
          "peak_bytes": peak, "kernels": launches["cli_valid_ensemble"],
          "card": card})
    return launches


# ---- phase 15: the back-translation speaker --------------------------------

# the golden speaker: JAX's Speaker initialised from PRNGKey(seed) on a tiny
# world; one item's path is cut to its first node (an all-False step mask)
GOLDEN_SPEAKER_SPEC = {
    "seed": 17,
    "world": {"num_scans": 1, "nodes_per_scan": 14, "feat_dim": 16,
              "seed": 41},
    "items": {"num_items": 4, "min_path": 2, "max_path": 5, "seed": 6},
    "one_node_path": 3,
    "model": {"max_steps": 4, "max_len": 12, "hidden": 64, "layers": 2,
              "heads": 2, "word_size": 32},
    # 56 words: 60 tokens with PAD, BOS, EOS and UNK; the synthetic
    # instructions' words come first
    "vocab": ("forward left right around straight through past into table "
              "door stairs kitchen sofa window hallway lamp walk then turn "
              "go the toward at and stop wait near beside up down exit "
              "enter red blue room bedroom bathroom chair bed rug painting "
              "plant counter sink mirror shelf desk piano arch corner step "
              "landing end halfway again").split(),
    "beam": 3,
    "length_penalties": [1.0, 0.7],
    "noise_seed": 5,
}
SPEAKER_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                               "golden_speaker_17.npz")
# the reference contract (transpeaker.py:34-39, parser.py:117-119) at
# main_nav's lengths: T 15, max_len min(--maxDecode, 80); bench.py
# --train's batch
SPEAKER_WIDTH = {"vocab_size": 992, "hidden": 512, "word_size": 256,
                 "layers": 3, "heads": 4, "max_steps": MAIN_T, "max_len": 80}
SPEAKER_BATCH, SPEAKER_BEAM, SPEAKER_STEPS = 16, 4, 3
TRAIN_SPEAKER_FLAGS = ["--synthetic_feat_dim", "768", "--iters", "3",
                       "--log_every", "3"]
# run_r2r_kdl.sh's student recipe without the distillation, which phase 13
# (b) runs: what is new here is the speaker's aug batches (with the
# teacher, each run took 23-25 s and the phase 94 s)
SPEAKER_CLI_FLAGS = [
    "--dataset", "r2r", "--mode", "train", "--train_alg", "dagger",
    "--batch_size", "16", "--lr", "4e-5", "--ml_weight", "0.2",
    "--max_action_len", "15", "--max_instr_len", "200", "--expert_policy",
    "spl", "--feat_dropout", "0.4", "--student_hidden_size", "128",
    "--student_num_attention_heads", "2"]


def speaker_world_items(module, spec=GOLDEN_SPEAKER_SPEC):
    """The golden speaker's world and items from either package's ``env``
    module."""
    world = module.make_synthetic_world(**spec["world"])
    i = spec["items"]
    items = module.synthetic.make_synthetic_instructions(
        world, i["num_items"], np.random.default_rng(i["seed"]),
        min_path=i["min_path"], max_path=i["max_path"])
    k = spec["one_node_path"]
    items[k]["path_idx"] = np.asarray(items[k]["path_idx"])[:1]
    return world, items


def speaker_outputs(sp, items, tok, spec=GOLDEN_SPEAKER_SPEC) -> dict:
    """What the golden speaker fixture holds, from the port's ``Speaker``
    ``sp`` in ``eval()``: the teacher-forced logits, loss and gradients
    (flax names and layouts), the greedy decode and the beam decodes at
    each length penalty, as numpy."""
    from vln_magic_tpu_torch.models.speaker import beam_decode
    from vln_magic_tpu_torch.utils.weights import flax_named_grads

    sp.model.eval()
    cand, pano, masks = sp._tensors(*sp.path_features(items))
    tokens, tok_masks = sp._tensors(*sp.encode_targets(items, tok))
    with torch.no_grad():
        logits = sp.model(cand, pano, masks, tokens[:, :-1].long())
    sp.model.zero_grad()
    loss = sp.loss(cand, pano, masks, tokens, tok_masks)
    loss.backward()
    out = {"logits": logits.cpu().numpy(), "loss": np.float32(loss.item()),
           "greedy": sp.infer_batch(items, tok)}
    out.update({f"g/{k}": v.cpu().numpy()
                for k, v in flax_named_grads(sp.model).items()})
    sp.model.zero_grad()
    for lp in spec["length_penalties"]:
        toks, scores = beam_decode(sp.model, cand, pano, masks, sp.L,
                                   tok.BOS, tok.EOS, beam=spec["beam"],
                                   length_penalty=lp)
        out[f"beam/{lp}/tokens"] = toks.to(torch.int32).cpu().numpy()
        out[f"beam/{lp}/scores"] = scores.cpu().numpy()
    return out


def check_speaker(got: dict, want: dict) -> dict:
    """``speaker_outputs`` against JAX's (``want``, the fixture's or a live
    run's): the logits within 1e-5, the loss within 1e-6 relative, the
    gradients within 1e-5 relative L2, the greedy and beam tokens equal
    (a greedy token may differ only where JAX's top-2 logit gap,
    ``greedy_gap``, is under 1e-5 at the first differing position) and the
    beam scores within 1e-5 (relative above 1).  Returns the errors;
    raises when one is over its tolerance."""
    errs, bad = {}, []
    errs["logits"] = float(np.max(np.abs(got["logits"] - want["logits"])))
    errs["loss_rel"] = float(abs(got["loss"] - want["loss"])
                             / abs(want["loss"]))
    names = sorted(k for k in want if k.startswith("g/"))
    if sorted(k for k in got if k.startswith("g/")) != names:
        bad.append("gradient names")
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in names)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in names)
    errs["grads_rel_l2"] = math.sqrt(num / den)
    for key, tol in (("logits", 1e-5), ("loss_rel", 1e-6),
                     ("grads_rel_l2", 1e-5)):
        if not errs[key] <= tol:
            bad.append(f"{key} {errs[key]} > {tol}")
    diff = np.argwhere(got["greedy"] != want["greedy"])
    errs["greedy_tokens_differing"] = int(len(diff))
    if len(diff):
        b = diff[0][0]
        i = int(np.flatnonzero(got["greedy"][b] != want["greedy"][b])[0])
        gap = float(want["greedy_gap"][b, i - 1])
        errs["greedy_first_diff_gap"] = gap
        if not gap < 1e-5:
            bad.append(f"greedy row {b} differs at {i} (JAX's top-2 gap "
                       f"{gap})")
    errs["beam_scores"] = 0.0
    for k in [k for k in want if k.startswith("beam/")]:
        if k.endswith("/tokens"):
            if not np.array_equal(got[k], want[k]):
                bad.append(f"{k} differ")
        else:
            err = np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1)
            errs["beam_scores"] = max(errs["beam_scores"], float(err.max()))
            if not err.max() <= 1e-5:
                bad.append(f"{k} {float(err.max())} > 1e-5")
    if bad:
        raise AssertionError("golden speaker: " + "; ".join(bad))
    return errs


def golden_speaker_port(device="cuda", spec=GOLDEN_SPEAKER_SPEC):
    """The port's golden speaker (the fixture's weights on its world):
    (speaker, items, tokenizer)."""
    from vln_magic_tpu_torch import env as tenv
    from vln_magic_tpu_torch.agent.speaker import Speaker, SpeakerTokenizer
    from vln_magic_tpu_torch.utils.weights import load_flax_params

    world, items = speaker_world_items(tenv, spec)
    tok = SpeakerTokenizer(list(spec["vocab"]))
    sp = Speaker(world, feat_dim=spec["world"]["feat_dim"],
                 vocab_size=tok.vocab_size, device=device, **spec["model"])
    fx = np.load(SPEAKER_FIXTURE)
    load_flax_params(sp.model, {k[2:]: fx[k] for k in fx.files
                                if k.startswith("w/")})
    return sp, items, tok


def golden_speaker(device="cuda"):
    """``SPEAKER_FIXTURE`` through the port: ``check_speaker``'s errors."""
    fx = dict(np.load(SPEAKER_FIXTURE))
    if json.loads(str(fx["spec"])) != json.loads(json.dumps(
            GOLDEN_SPEAKER_SPEC)):
        raise AssertionError("golden speaker: the fixture's spec is not "
                             "GOLDEN_SPEAKER_SPEC")
    sp, items, tok = golden_speaker_port(device)
    return check_speaker(speaker_outputs(sp, items, tok), fx)


def native_against_numpy(seed=0):
    """The port's C++ ``native`` against its numpy versions on a random
    corpus: BLEU counts, edit distances, batches and WER equal.  Returns
    the corpus size and the C++ BLEU."""
    from vln_magic_tpu_torch import native

    if not native.native_available():
        raise AssertionError("native: the g++ build failed")
    rng = np.random.default_rng(seed)
    seqs = lambda n: [rng.integers(0, 30, rng.integers(0, 40)).tolist()
                      for _ in range(n)]
    hyps, refs = seqs(256), seqs(256)
    lengths = rng.integers(1, 60, 500)
    words = [" ".join(f"w{x}" for x in s) for s in hyps]

    def run():
        return {"bleu_counts": native.bleu_counts(hyps, refs).tolist(),
                "bleu": native.bleu_score(hyps, refs),
                "edit_distance": native.edit_distance(hyps, refs).tolist(),
                "batches": [b.tolist() for b in native.batch_by_size(
                    lengths, max_tokens=400, max_sentences=16)],
                "wer": native.wer(hyps, refs),
                "wer_text": native.wer(words, words[::-1])}

    cpp = run()
    orig = native._load
    native._load = lambda: None
    try:
        plain = run()
    finally:
        native._load = orig
    if cpp != plain:
        raise AssertionError("native: the C++ results differ from numpy's: "
                             + str([k for k in cpp if cpp[k] != plain[k]]))
    return {"pairs": len(hyps), "bleu": cpp["bleu"], "wer": cpp["wer"],
            "library": os.path.relpath(native.lib_path(), ROOT)}


def _speaker_vocab(items, size=988):
    """``size`` words: those of ``items``' instructions, then fillers."""
    words = sorted({w.lower().strip(".,!?") for it in items
                    for w in it["instruction"].split()})
    return words + [f"word{i}" for i in range(size - len(words))]


def _no_launches(what, fn):
    """``fn()`` with the attention kernels' counts at 0 just before and
    read just after; none may launch.  Returns (result, launches)."""
    _reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"{what}: attention kernel launches "
                             f"{launches}, want 0 (the speaker's attention "
                             "is the einsum path, as JAX's)")
    return out, launches


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _profiled_decode(fn):
    """``device_breakdown`` of ``fn()`` under ``torch.profiler``: its
    device kernels' launches and time, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_breakdown(prof, 1e3 * (time.perf_counter() - t0), top=3)


def _speaker_full_width(card, world, items):
    """Phase 15 (b): the speaker at the reference contract's width."""
    from vln_magic_tpu_torch.agent.speaker import Speaker, SpeakerTokenizer

    w = SPEAKER_WIDTH
    tok = SpeakerTokenizer(_speaker_vocab(items, w["vocab_size"] - 4))
    sp = Speaker(world, feat_dim=world.tables.feat_dim,
                 vocab_size=tok.vocab_size, device="cuda",
                 **{k: v for k, v in w.items() if k != "vocab_size"})
    batch = items[:SPEAKER_BATCH]
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(SPEAKER_STEPS + 1):
        (loss, ms) = _synced_ms(lambda: sp.train_step(batch, tok))
        if not math.isfinite(loss):
            raise AssertionError(f"speaker train_step: loss {loss}")
        step_ms.append(ms)
    _, launches["speaker_train_step"] = _no_launches(
        "speaker train_step", lambda: sp.train_step(batch, tok))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    sp.path_features(batch)
    feat_ms = 1e3 * (time.perf_counter() - t0)
    sp.infer_batch(batch, tok)                            # warm-up
    greedy, launches["speaker_greedy"] = _no_launches(
        "speaker greedy", lambda: _synced_ms(
            lambda: sp.infer_batch(batch, tok)))
    beam, launches["speaker_beam"] = _no_launches(
        "speaker beam", lambda: _synced_ms(lambda: sp.back_translate(
            batch, tok, rng=1, beam=SPEAKER_BEAM)))
    greedy_prof = _profiled_decode(lambda: sp.infer_batch(batch, tok))
    beam_prof = _profiled_decode(lambda: sp.back_translate(
        batch, tok, rng=1, beam=SPEAKER_BEAM))
    tokens, bleu = greedy[0], sp.evaluate(batch, tok)
    if tokens.shape != (SPEAKER_BATCH, w["max_len"]) or \
            not (tokens[:, 0] == tok.BOS).all():
        raise AssertionError(f"speaker greedy decode: {tokens.shape}")
    emit({"phase": "speaker_full_width", "width": w,
          "feat_size": world.tables.feat_dim + 128, "batch": SPEAKER_BATCH,
          "compute": "float32, TF32 off",
          "train_step_ms": sorted(step_ms[1:])[len(step_ms[1:]) // 2],
          "train_step_ms_all": step_ms, "peak_bytes": peak,
          "path_features_host_ms": feat_ms,
          "greedy_ms": greedy[1], "greedy_profile": greedy_prof,
          "beam_ms": beam[1], "beam": SPEAKER_BEAM,
          "beam_profile": beam_prof,
          "decode_positions": w["max_len"] - 1,
          "bleu_random_weights": bleu, "native": native_against_numpy(),
          "kernels": launches, "card": card})
    return sp, tok, launches


def _speaker_fit(card, world, items, sp, tok):
    """Phase 15 (c): ``Trainer.fit(speaker=)`` at ``bench.py --train``'s
    shape, two iterations: a train batch, then an aug batch
    back-translated by the full-width speaker."""
    from vln_magic_tpu_torch.agent.speaker import Speaker
    from vln_magic_tpu_torch.agent.trainer import Trainer

    tr = Trainer(train_config(), world, device="cuda")
    train_items = items[:TRAIN_BATCH]
    aug_items = [dict(it) for it in items[TRAIN_BATCH:2 * TRAIN_BATCH]]
    with _recorded(Trainer, "train_step") as steps, \
            _recorded(Speaker, "back_translate") as bts:
        (hist, wall), launches = _no_launches(
            "fit(speaker=)", lambda: _synced_ms(lambda: tr.fit(
                train_items, 2, aug_items=aug_items, speaker=sp,
                speaker_tok=tok, aug_times=1)))
    if [h["aug"] for h in hist] != [0.0, 1.0] or len(bts) != 1:
        raise AssertionError(f"fit(speaker=): aug flags "
                             f"{[h['aug'] for h in hist]}, "
                             f"{len(bts)} back-translations")
    _finite("fit(speaker=)", hist)
    from vln_magic_tpu_torch.data.tokenizer import HashTokenizer

    # the aug batch that train_step received is the back-translated one,
    # re-encoded with the navigator's tokenizer
    got, translated = steps[1][1][1], bts[0][2][0]
    enc = HashTokenizer(tr.cfg.model.vocab_size).encode
    if got is not translated or any(
            not np.array_equal(b["instr_encoding"], enc(b["instruction"]))
            for b in got):
        raise AssertionError("fit(speaker=): the aug batch was not the "
                             "back-translated, re-encoded one")
    bt_ms = 1e3 * bts[0][0]
    step_ms = [1e3 * s[0] for s in steps]
    emit({"phase": "speaker_fit", "config": "bench.py --train (train_config)",
          "iterations": 2, "wall_ms": wall, "train_step_ms": step_ms,
          "back_translate_ms": bt_ms,
          "iteration_ms": [step_ms[0], step_ms[1] + bt_ms],
          "back_translate_share": bt_ms / (step_ms[1] + bt_ms),
          "metrics": hist, "kernels": launches, "card": card})
    return launches


def _train_speaker_cli(card):
    """Phase 15 (d): ``train_speaker`` at full width, then a ``--speaker``
    resume."""
    import shutil
    import tempfile

    from vln_magic_tpu_torch.cli.train_speaker import main as speaker_main

    tmp = tempfile.mkdtemp(prefix="chip_smoke_speaker_")
    runs, launches = [], {}
    try:
        out = os.path.join(tmp, "speaker")
        for name, extra in (("speaker_train_cli", []),
                            ("speaker_train_cli_resume",
                             ["--speaker", os.path.join(out, "speaker.pt"),
                              "--iters", "2", "--log_every", "2"])):
            argv = TRAIN_SPEAKER_FLAGS + ["--output_dir", out] + extra
            (res, ms), launches[name] = _no_launches(
                name, lambda: _synced_ms(lambda: speaker_main(argv)))
            runs.append({"argv": argv[len(TRAIN_SPEAKER_FLAGS):] or None,
                         "wall_ms": ms})
        with open(os.path.join(out, "speaker.txt")) as f:
            record = f.read()
        if f"resumed speaker from {out}/speaker.pt (epoch 4)" not in record:
            raise AssertionError(f"train_speaker: no resume line in "
                                 f"{record!r}")
        lines = [ln for ln in record.splitlines() if ln.startswith("iter ")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "speaker_train_cli", "flags": TRAIN_SPEAKER_FLAGS,
          "runs": runs, "log": lines, "kernels": launches, "card": card})
    return launches


def phase_speaker_cli(card, root, out):
    """Phase 15 (d), on phase 13's tree: ``SPEAKER_CLI_FLAGS`` with an aug
    split and ``--use_transpeaker`` for two iterations (one aug batch,
    back-translated), then again from its ``speaker_latest.pt`` with
    ``--loadOptim``.  Returns (the launches of each run, all 0, the wall
    seconds of both)."""
    import shutil

    from vln_magic_tpu_torch.agent.speaker import Speaker
    from vln_magic_tpu_torch.cli.main_nav import parse_args

    t0 = time.perf_counter()
    anno = os.path.join(root, "R2R", "annotations")
    # --aug names a file whose base name is the split: R2R_aug_enc.json
    shutil.copy(os.path.join(anno, "R2R_train_enc.json"),
                os.path.join(anno, "R2R_aug_enc.json"))
    open(os.path.join(anno, "aug"), "w").close()
    base = SPEAKER_CLI_FLAGS + ["--root_dir", root, "--iters", "2",
                            "--log_every", "2", "--for_debug",
                            "--aug", os.path.join(anno, "aug"),
                            "--use_transpeaker", "--output_dir", out]
    runs, launches, ckpt = [], {}, None
    for name in ("speaker_cli", "speaker_cli_resume"):
        argv = base + ["--name", f"r2r_{name}"]
        if ckpt:
            argv += ["--speaker", ckpt, "--loadOptim"]
        with _recorded(Speaker, "back_translate") as bts:
            trainer, wall, peak, launches[name] = _cli(argv)
        if len(bts) != 1:
            raise AssertionError(f"{name}: {len(bts)} back-translations in "
                                 "two iterations, want 1")
        a = parse_args(argv)
        ckpt = os.path.join(a.ckpt_dir, "speaker_latest.pt")
        if not os.path.exists(ckpt):
            raise AssertionError(f"{name}: no {ckpt}")
        with open(os.path.join(a.log_dir, "train.txt")) as f:
            record = f.read()
        runs.append({"name": name, "wall_s": wall, "peak_bytes": peak,
                     "iteration": trainer.iteration,
                     "back_translate_ms": 1e3 * bts[0][0]})
    want = f"loaded speaker checkpoint {argv[argv.index('--speaker') + 1]}"
    if want not in record:
        raise AssertionError(f"cli speaker: no '{want}' in train.txt")
    wall = time.perf_counter() - t0
    emit({"phase": "speaker_cli", "flags": "SPEAKER_CLI_FLAGS + --iters 2 "
          "--log_every 2 --for_debug --aug <R2R_aug_enc.json> "
          "--use_transpeaker; then --speaker speaker_latest.pt --loadOptim",
          "runs": runs, "record_line": want, "wall_s": wall,
          "kernels": launches, "card": card})
    return launches, wall


def phase_speaker(card, world, items, cli):
    """Phase 15: the golden speaker in f32, the speaker at full width,
    ``Trainer.fit(speaker=)`` and ``train_speaker``; ``cli`` is what
    ``phase_speaker_cli`` returned on phase 13's tree.  Returns the
    launches of each speaker path (all 0)."""
    launches, cli_wall = cli
    t0 = time.perf_counter()
    errs = golden_speaker()
    emit({"phase": "golden_speaker", "fixture": os.path.relpath(
        SPEAKER_FIXTURE, ROOT), "errors": errs,
          "tf32": torch.backends.cuda.matmul.allow_tf32, "card": card})
    sp, tok, width = _speaker_full_width(card, world, items)
    launches = {**width, **launches}
    launches["speaker_fit"] = _speaker_fit(card, world, items, sp, tok)
    launches.update(_train_speaker_cli(card))
    wall = time.perf_counter() - t0
    emit({"phase": "speaker", "wall_s": wall + cli_wall,
          "wall_s_parts": {"a_b_c_train_speaker": wall, "main_nav": cli_wall},
          "kernels": launches, "card": card})
    return launches


# ---- phase 17: long context (ROADMAP Queue 1 item 8) ------------------------

# the golden long-context fixture: the port draws every weight from
# ``seed`` with numpy (JAX's initialisers' distributions, models/_init.py),
# JAX's values on the same weights (carried by flax name) and inputs are
# kept; tests/test_torch_long_context.py rewrites it
GOLDEN_LONG_CONTEXT_SPEC = {
    "seed": 23,
    "ema": {"b": 2, "l": 37, "d": 8, "n": 4},
    "mega": {"hidden": 32, "chunk_size": 8, "ema_ndim": 4, "b": 2, "l": 20},
    "luna": {"hidden": 32, "heads": 2, "intermediate": 64, "proj_len": 8,
             "b": 2, "l": 20},
    "lra": {"vocab": 16, "classes": 2, "hidden": 32, "layers": 1,
            "heads": 2, "chunk_size": 24, "proj_len": 8, "b": 4, "l": 96,
            "lr": 3e-3, "steps": 3},
}
LONG_CONTEXT_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                    "golden_long_context_23.npz")
LRA_TRUNKS = ("mega", "luna", "dense")
# LRA Text (Tay et al. 2021, Long Range Arena): 4,096 byte tokens, 2
# classes; models/lra.py's default widths; batch 32
LRA_TEXT = {"vocab": 256, "classes": 2, "l": 4096, "b": 32}
LONG_CONTEXT_TOL = 1e-4         # f32, relative to each output's scale


def long_context_inputs(spec=GOLDEN_LONG_CONTEXT_SPEC) -> dict:
    """The golden inputs, from the spec's seed (numpy)."""
    rng = np.random.default_rng(spec["seed"])
    e, m, lu, lr = spec["ema"], spec["mega"], spec["luna"], spec["lra"]
    mask = lambda b, l: np.arange(l)[None] < np.array(
        [l] + [l - 5 - i for i in range(b - 1)])[:, None]
    return {
        "ema_x": rng.standard_normal((e["b"], e["l"], e["d"])).astype(
            np.float32),
        "ema_alpha": rng.uniform(0.1, 0.9, (e["d"], e["n"])).astype(
            np.float32),
        "ema_delta": rng.uniform(0.1, 0.9, (e["d"], e["n"])).astype(
            np.float32),
        "ema_beta": rng.standard_normal((e["d"], e["n"])).astype(np.float32),
        "ema_eta": rng.standard_normal((e["d"], e["n"])).astype(np.float32),
        "ema_h0": rng.standard_normal((e["b"], e["d"], e["n"])).astype(
            np.float32),
        "mega_x": rng.standard_normal((m["b"], m["l"], m["hidden"])).astype(
            np.float32),
        "mega_mask": mask(m["b"], m["l"]),
        "luna_x": rng.standard_normal((lu["b"], lu["l"], lu["hidden"])
                                      ).astype(np.float32),
        "luna_p": rng.standard_normal((lu["b"], lu["proj_len"],
                                       lu["hidden"])).astype(np.float32),
        "luna_mask": mask(lu["b"], lu["l"]),
        "lra_tokens": rng.integers(0, lr["vocab"], (lr["b"], lr["l"])),
        "lra_mask": mask(lr["b"], lr["l"]),
        "lra_labels": rng.integers(0, lr["classes"], lr["b"]),
    }


def long_context_models(device="cuda", spec=GOLDEN_LONG_CONTEXT_SPEC):
    """The port's golden modules, weights from the spec's seed: a Mega
    block, a Luna layer and the LRA classifier with each trunk."""
    from vln_magic_tpu_torch.models._init import flax_default_init
    from vln_magic_tpu_torch.models.lra import LRAClassifier
    from vln_magic_tpu_torch.models.luna import LunaEncoderLayer
    from vln_magic_tpu_torch.models.mega import MovingAverageGatedAttention

    m, lu, lr = spec["mega"], spec["luna"], spec["lra"]
    rng = np.random.default_rng(spec["seed"])
    mega = MovingAverageGatedAttention(m["hidden"], chunk_size=m["chunk_size"],
                                       ema_ndim=m["ema_ndim"])
    mega.init_weights(rng)
    luna = LunaEncoderLayer(lu["hidden"], lu["heads"], lu["intermediate"],
                            dropout=0.0)
    flax_default_init(luna, rng)
    models = {"mega": mega.to(device), "luna": luna.to(device)}
    for i, trunk in enumerate(LRA_TRUNKS):
        models[f"lra_{trunk}"] = LRAClassifier(
            lr["vocab"], lr["classes"], lr["hidden"], lr["layers"],
            lr["heads"], trunk, chunk_size=lr["chunk_size"],
            proj_len=lr["proj_len"], seed=spec["seed"] + i, device=device)
    return models


def long_context_outputs(models, device="cuda",
                         spec=GOLDEN_LONG_CONTEXT_SPEC) -> dict:
    """The port's golden values: the EMA scan with and without h0, the
    Mega block and Luna layer (masked), each LRA classifier's logits, then
    ``spec["lra"]["steps"]`` ``lra_train_step``s under Adam (losses, the
    logits after)."""
    from vln_magic_tpu_torch.models.lra import lra_train_step
    from vln_magic_tpu_torch.ops.ema import damped_ema_scan

    x = {k: torch.as_tensor(v, device=device)
         for k, v in long_context_inputs(spec).items()}
    host = lambda t: t.detach().float().cpu().numpy()
    out = {}
    ema = [x[f"ema_{k}"] for k in ("x", "alpha", "delta", "beta", "eta")]
    with torch.no_grad():
        out["ema_y"], out["ema_h"] = map(host, damped_ema_scan(*ema))
        out["ema_y_h0"], out["ema_h_h0"] = map(host, damped_ema_scan(
            *ema, x["ema_h0"]))
        out["mega_y"] = host(models["mega"](x["mega_x"], x["mega_mask"]))
        out["luna_x"], out["luna_p"] = map(host, models["luna"](
            x["luna_x"], x["luna_p"], x["luna_mask"]))
    for trunk in LRA_TRUNKS:
        model = models[f"lra_{trunk}"]
        with torch.no_grad():
            out[f"lra_{trunk}_logits"] = host(model(x["lra_tokens"],
                                                    x["lra_mask"]))
        step = lra_train_step(model, torch.optim.Adam(
            model.parameters(), lr=spec["lra"]["lr"]))
        losses = [step(x["lra_tokens"], x["lra_mask"], x["lra_labels"])[0]
                  for _ in range(spec["lra"]["steps"])]
        out[f"lra_{trunk}_losses"] = host(torch.stack(losses))
        with torch.no_grad():
            out[f"lra_{trunk}_logits_after"] = host(model(x["lra_tokens"],
                                                          x["lra_mask"]))
    return out


def check_long_context(got: dict, want: dict,
                       tol=LONG_CONTEXT_TOL) -> dict:
    """Each golden value's largest error relative to its scale; raises
    past ``tol``."""
    errs = {}
    for k, g in got.items():
        w = np.asarray(want[k], np.float32)
        if g.shape != w.shape:
            raise AssertionError(f"long context {k}: shape {g.shape} != "
                                 f"{w.shape}")
        errs[k] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1.0))
        if not np.isfinite(g).all() or errs[k] > tol:
            raise AssertionError(f"long context {k}: error {errs[k]:.3g} "
                                 f"past {tol}")
    return errs


def golden_long_context(device="cuda") -> dict:
    """``LONG_CONTEXT_FIXTURE`` through the port: ``check_long_context``'s
    errors."""
    fx = dict(np.load(LONG_CONTEXT_FIXTURE))
    if json.loads(str(fx.pop("spec"))) != json.loads(json.dumps(
            GOLDEN_LONG_CONTEXT_SPEC)):
        raise AssertionError("golden long context: the fixture's spec is "
                             "not GOLDEN_LONG_CONTEXT_SPEC")
    got = long_context_outputs(long_context_models(device), device)
    return check_long_context(got, fx)


# ---- phase 16: the mesh (ROADMAP Queue 1 item 7) -----------------------------

# phase 16 (b): two ranks on the one card, at a reduced depth and in f32
# (the kernel's SIMT route), so that the two-rank runs equal one process
# at the CPU tests' tolerances
MESH_DEPTH = {"num_l_layers": 2, "num_pano_layers": 1, "num_x_layers": 1}
MESH_ITEMS = 32


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_env(rank: int, world: int, port: int, local_rank: int = 0):
    """The environment torchrun gives a rank (``parallel.init_distributed``
    reads it)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))


def mesh_reduced_path():
    """Phase 16 (b)'s navigator configuration, world and items: the main
    path's model at ``MESH_DEPTH``, f32, one 64-node scan, 32 items of 200
    tokens."""
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    cfg = main_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **MESH_DEPTH),
        train=dataclasses.replace(cfg.train, batch_size=MESH_ITEMS,
                                  compute_dtype="float32"))
    world = make_synthetic_world(num_scans=1, nodes_per_scan=64,
                                 feat_dim=768, seed=0)
    rng = np.random.default_rng(4)
    items = make_synthetic_instructions(world, MESH_ITEMS, rng, min_path=4,
                                        max_path=7)
    for it in items:
        it["instr_encoding"] = rng.integers(4, 1000, 200).astype(np.int32)
    return cfg, world, items


def mesh_rank(case: str, rank: int, port: int, out_dir: str):
    """One rank of phase 16 (b) (``chip_smoke.py --mesh-rank``): a gloo
    group of two processes on the one card (NCCL refuses two ranks on one
    device), a dp 2 or mp 2 mesh on cuda:0, one wave of the reduced
    navigator; under mp every packed call (at the rank's heads) is held
    against the plain version.  Writes ``<out_dir>/<case>_<rank>.json``."""
    sys.path.insert(0, ROOT)
    from vln_magic_tpu_torch import parallel
    from vln_magic_tpu_torch.agent.navigator import Navigator

    _torchrun_env(rank, 2, port)
    parallel.init_distributed("cuda", backend="gloo")
    try:
        mesh = parallel.make_mesh(mp=2 if case == "mp2" else 1,
                                  device="cuda:0", backend="gloo")
        cfg, world, items = mesh_reduced_path()
        nav = Navigator(cfg, world, seed=0, device="cuda").use_mesh(mesh)
        nav.evaluate(items)                         # warm-up
        run = lambda: timed_evaluate(nav, items)
        if case == "mp2":
            (avg, preds, wall, launches), calls = _captured_packed(run)
            rows = _check_calls(calls, F32_TOL, tensor_cores=False)
        else:
            avg, preds, wall, launches = run()
            rows = []
        with open(os.path.join(out_dir, f"{case}_{rank}.json"), "w") as f:
            json.dump({"traj": [p["trajectory"] for p in preds], "avg": avg,
                       "wall_s": wall, "launches": launches,
                       "checked": rows,
                       "heads": nav.model.lang_encoder.layer_0.attention.h},
                      f)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _mesh_pair(case: str) -> list[dict]:
    """Phase 16 (b)'s two ranks of ``case`` as processes of this script:
    their results by rank."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as out:
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--mesh-rank", case, str(r), str(port),
                                   out]) for r in range(2)]
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0, 0]:
            raise AssertionError(f"mesh {case}: the ranks exited {rcs}")
        res = []
        for r in range(2):
            with open(os.path.join(out, f"{case}_{r}.json")) as f:
                res.append(json.load(f))
    return res


def phase_mesh(card, nav, items, world):
    """Phase 16: (a) one process over NCCL at world size 1 through
    ``make_mesh``: ``Navigator.use_mesh`` runs a wave at the main path's
    shape (the trajectories of phase 4's navigator, 216 launches),
    ``Trainer.use_mesh`` a default train step at ``bench.py --train``'s
    shape beside the step without a mesh (the same batch and seed),
    ``PretrainTrainer.use_mesh`` one sap step; (b) two processes on the
    one card, dp 2 then mp 2, each wave equal to one process's."""
    import torch.distributed as dist

    from vln_magic_tpu_torch import parallel
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.agent.trainer import Trainer
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.pretrain.loader import ItemSampler, batch_to_device
    from vln_magic_tpu_torch.pretrain.trainer import PretrainTrainer

    t_phase = time.perf_counter()
    (ref_avg, _), ref_preds = nav.evaluate(items)
    _torchrun_env(0, 1, _free_port())
    parallel.init_distributed("cuda")
    try:
        mesh = parallel.make_mesh(mp=1)
        if (mesh.backend, dist.get_backend()) != ("nccl", "nccl"):
            raise AssertionError(f"phase 16 (a) ran on {mesh.backend}")
        mnav = Navigator(main_config(), world, seed=0,
                         device="cuda").use_mesh(mesh)
        mnav.evaluate(items)
        avg, preds, wall, launches = timed_evaluate(mnav, items)
        if launches["packed_attention"] != LAUNCHES_PER_WAVE or \
                launches["fused_attention"]:
            raise AssertionError(f"mesh wave: {launches}")
        check_tensor_cores("mesh wave", launches)
        if [p["trajectory"] for p in preds] != \
                [p["trajectory"] for p in ref_preds]:
            raise AssertionError("mesh wave: trajectories differ from "
                                 "phase 4's navigator")
        del mnav
        emit({"phase": "mesh_wave", "mesh": repr(mesh), "wall_s": wall,
              "kernels": launches, "metrics": avg, "card": card})

        cfg = train_config()
        rng = np.random.default_rng(2)
        t_items = make_synthetic_instructions(world, TRAIN_BATCH, rng,
                                              min_path=4, max_path=7)
        for it in t_items:
            it["instr_encoding"] = rng.integers(4, 1000, 200).astype(
                np.int32)
        steps = {}
        for name in ("plain", "mesh"):
            tr = Trainer(cfg, world, device="cuda")
            if name == "mesh":
                tr.use_mesh(mesh)
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(t_items)
            torch.cuda.synchronize()
            steps[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "metrics": m, "kernels": _launches()}
            del tr
        _check_steps("mesh train step", [steps["mesh"]["metrics"]],
                     steps["mesh"]["kernels"])
        rel = abs(steps["mesh"]["metrics"]["loss"]
                  - steps["plain"]["metrics"]["loss"]) / max(
            abs(steps["plain"]["metrics"]["loss"]), 1e-12)
        if rel > 1e-4:
            raise AssertionError(f"mesh train step: loss {rel:.3g} off the "
                                 f"step without a mesh")
        emit({"phase": "mesh_train_step", "batch": TRAIN_BATCH,
              "loss_rel_err": rel, **{f"{k}_ms": v["ms"]
                                      for k, v in steps.items()},
              "metrics": steps["mesh"]["metrics"],
              "kernels": steps["mesh"]["kernels"], "card": card})

        pcfg = pretrain_config()
        pt = PretrainTrainer(pcfg, world, device="cuda").use_mesh(mesh)
        rng = np.random.default_rng(3)
        p_items = make_synthetic_instructions(world, PRETRAIN_BATCH, rng,
                                              min_path=4, max_path=7,
                                              vocab_size=pcfg.model.vocab_size)
        for it in p_items:
            it["instr_encoding"] = rng.integers(4, 1000, 200).astype(
                np.int32)
        batch = batch_to_device(pt._fill("sap", pt.builder.sap_batch(
            ItemSampler(p_items, PRETRAIN_BATCH, 0).next_batch())), "cuda")
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm = pt.train_step("sap", batch)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        p_launches = _simt_launches("mesh pretraining sap",
                                    PRETRAIN_LAUNCHES["sap"])
        _finite("mesh pretraining sap", [pm])
        del pt
        emit({"phase": "mesh_pretrain_step", "task": "sap",
              "batch": PRETRAIN_BATCH, "ms": p_ms, "metrics": pm,
              "kernels": {"packed_attention": p_launches}, "card": card})
    finally:
        dist.destroy_process_group()

    # (b) two ranks on the one card over gloo, against one process
    cfg, r_world, r_items = mesh_reduced_path()
    one = Navigator(cfg, r_world, seed=0, device="cuda")
    (one_avg, _), one_preds = one.evaluate(r_items)
    del one
    pair = {}
    for case in ("dp2", "mp2"):
        ranks = _mesh_pair(case)
        for r in ranks:
            if r["launches"]["fused_attention"] or \
                    not r["launches"]["packed_attention"]:
                raise AssertionError(f"mesh {case}: {r['launches']}")
            if r["traj"] != [p["trajectory"] for p in one_preds]:
                raise AssertionError(f"mesh {case}: trajectories differ "
                                     f"from one process")
            for k, v in one_avg.items():
                if not math.isclose(r["avg"][k], v, rel_tol=1e-5,
                                    abs_tol=1e-9):
                    raise AssertionError(f"mesh {case}: {k} {r['avg'][k]} "
                                         f"against one process's {v}")
        pair[case] = ranks[0]["launches"]["packed_attention"]
        emit({"phase": f"mesh_{case}_wave", "ranks": 2, "backend": "gloo",
              "heads_per_rank": ranks[0]["heads"],
              "wall_s": [r["wall_s"] for r in ranks],
              "kernels": [r["launches"] for r in ranks],
              "checked": ranks[0]["checked"] + ranks[1]["checked"],
              "card": card})
    emit({"phase": "mesh", "wall_s": time.perf_counter() - t_phase,
          "card": card})
    return {"mesh_wave": launches["packed_attention"],
            "mesh_train_step": steps["mesh"]["kernels"],
            "mesh_pretrain_step": p_launches,
            "mesh_dp2_wave": pair["dp2"], "mesh_mp2_wave": pair["mp2"]}


def phase_long_context(card, nav, items):
    """Phase 17: the golden long-context fixture on the card (the EMA
    scan, a Mega block, a Luna layer, the LRA classifier with each trunk:
    logits and ``lra_train_step``s); one LRA train step per trunk at LRA
    Text's shape (ms, peak memory, idle share; 0 attention launches); then
    the utilities on the card: ``trace`` around a wave names the packed
    kernel, ``device_memory_stats`` gives the card's figures, ``NanGuard``
    wraps a train step."""
    from torch.profiler import ProfilerActivity, profile

    from vln_magic_tpu_torch.models.lra import LRAClassifier, lra_train_step
    from vln_magic_tpu_torch.utils.debug import NanGuard
    from vln_magic_tpu_torch.utils.profiling import (device_memory_stats,
                                                     trace)

    t_phase = time.perf_counter()
    errs = golden_long_context("cuda")
    emit({"phase": "long_context_golden", "max_rel_err": errs,
          "tol": LONG_CONTEXT_TOL, "card": card})

    rng = np.random.default_rng(5)
    L, b = LRA_TEXT["l"], LRA_TEXT["b"]
    tokens = torch.as_tensor(rng.integers(0, LRA_TEXT["vocab"], (b, L)),
                             device="cuda")
    mask = torch.ones((b, L), dtype=torch.bool, device="cuda")
    labels = torch.as_tensor(rng.integers(0, 2, b), device="cuda")
    launches = {}
    for trunk in LRA_TRUNKS:
        model = LRAClassifier(LRA_TEXT["vocab"], LRA_TEXT["classes"],
                              encoder=trunk, device="cuda")
        step = NanGuard()(lra_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-3)))
        step(tokens, mask, labels)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        loss, acc = step(tokens, mask, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches[trunk] = _launches()
        if any(launches[trunk].values()):
            raise AssertionError(f"LRA {trunk}: attention kernels "
                                 f"launched: {launches[trunk]}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(tokens, mask, labels)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        emit({"phase": "lra_text_step", "trunk": trunk, "batch": b,
              "tokens": L, "ms": ms, "peak_memory_gb": peak,
              "loss": float(loss), "acc": float(acc),
              "params": sum(p.numel() for p in model.parameters()),
              "profiled_ms": prof_ms,
              **device_breakdown(prof, prof_ms, top=5), "card": card})
        del model, step, prof
        torch.cuda.empty_cache()

    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as log_dir:
        with trace(log_dir):
            nav.evaluate(items[:16], batch_size=16)
        with open(os.path.join(log_dir, "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
    packed = sorted(n for n in names if "packed_attention" in n)
    if not packed:
        raise AssertionError("the trace of a wave names no packed kernel")
    stats = device_memory_stats()
    if not stats["cuda:0"]["bytes_limit"] > 0 or \
            stats["cuda:0"]["peak_bytes_in_use"] <= 0:
        raise AssertionError(f"device_memory_stats: {stats}")
    emit({"phase": "utils_on_card", "trace_packed_kernels": packed,
          "device_memory_stats": stats, "card": card})
    emit({"phase": "long_context", "wall_s": time.perf_counter() - t_phase,
          "card": card})
    return {f"lra_text_{k}": v["packed_attention"]
            for k, v in launches.items()}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import vln_magic_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = card_line()
    phase_card_and_build(card)
    packed = phase_kernel_vs_plain(card)
    walk_rows = phase_walk_vs_plain(card)
    phase_golden(card)
    nav, items, wave_launches = phase_main_path(card)
    stream_launches = phase_streaming(card, nav)
    parity_launches, parity_walks_launched, parity_walks = phase_parity(
        card, nav, items)
    fused = phase_fused(card)
    train_launches = phase_training(card, nav.world)
    phase_golden_train(card)
    golden_serve_launches = phase_serving_golden(card)
    serve = phase_serving(card)
    pretrain = phase_pretraining(card, nav.world)
    golden_pretrain_launches = phase_golden_pretrain(card)
    options = phase_model_options(card, nav, items)
    cli, (cli14, speaker_cli) = phase_cli(
        card, then=lambda root, out, pt: (
            phase_cli_interventions(card, root, out, pt),
            phase_speaker_cli(card, root, out)))
    cli.update({k: {"packed_attention": v["packed_attention"],
                    "fused_attention": v["fused_attention"]}
                for k, v in cli14.items()})
    speaker = phase_speaker(card, nav.world, items, speaker_cli)
    mesh = phase_mesh(card, nav, items, nav.world)
    long_context = phase_long_context(card, nav, items)
    emit({"phase": "script", "wall_s": time.perf_counter() - t_start,
          "card": card})
    cli_note = ("the CLI runs no kernel, as JAX's does not: no flag sets "
                "ModelConfig.use_pallas_attention; the speaker's attention "
                "is the einsum path (JAX: use_pallas=False)")
    by = lambda s: "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations"
    emit({"kernels": [{
        "name": "packed_attention", "route": "cuda",
        "source": "vln_magic_tpu_torch/csrc/packed_attention.cu",
        "replaces": "vln_magic_tpu/ops/attention.py:216",
        "launches": wave_launches, "max_abs_err": packed["max_abs_err"],
        "ms": packed["ms"], "plain_ms": packed["plain_ms"],
        "bound_ms": packed["bound_ms"], "bound_by": by(packed),
        "library_ms": packed["library_ms"],
        "eager_ms": packed["eager_ms"],
        "exact_limit_used": packed["exact_limit_used"],
        "serve_max_abs_err": serve["checked_max_abs_err"],
        "serve_exact_limit_used": serve["checked_exact_limit_used"],
        "pretrain_max_abs_err": pretrain["max_abs_err"],
        "pretrain_exact_limit_used": pretrain["exact_limit_used"],
        "pretrain_sap_step_ms": pretrain["sap_step"]["ms"],
        "pretrain_sap_step_plain_ms": pretrain["sap_step"]["plain_ms"],
        "pretrain_sap_step_bound_ms": pretrain["sap_step"]["bound_ms"],
        "pretrain_sap_step_library_ms": pretrain["sap_step"]["library_ms"],
        "fused_wave_max_abs_err": options["fused_max_abs_err"],
        "fused_wave_exact_limit_used": options["fused_exact_limit_used"],
        "launches_by_path": {"wave": wave_launches,
                             "stream": stream_launches,
                             "parity": parity_launches,
                             **{"train_step" if k == "default"
                                else f"train_{k}": v["packed_attention"]
                                for k, v in train_launches.items()},
                             "serve": serve["serve"],
                             "fleet": serve["fleet"],
                             "serve_golden_f32": golden_serve_launches,
                             "pretrain_step": pretrain["step"],
                             "pretrain_validate": pretrain["validate"],
                             "pretrain_golden_f32":
                                 golden_pretrain_launches,
                             "fused_wave": options["fused_wave"],
                             "fused_golden_f32": options["fused_golden_f32"],
                             "interventions_wave":
                                 options["interventions_wave"],
                             "interventions_golden_f32":
                                 options["interventions_golden_f32"],
                             "ensemble_wave": options["ensemble_wave"],
                             **{k: v["packed_attention"]
                                for k, v in cli.items()},
                             **{k: v["packed_attention"]
                                for k, v in speaker.items()},
                             "mesh_wave": mesh["mesh_wave"],
                             "mesh_train_step":
                                 mesh["mesh_train_step"]["packed_attention"],
                             "mesh_pretrain_step":
                                 mesh["mesh_pretrain_step"],
                             "mesh_dp2_wave": mesh["mesh_dp2_wave"],
                             "mesh_mp2_wave": mesh["mesh_mp2_wave"],
                             **long_context},
        "route_by_path": {"wave": "tensor_core", "stream": "tensor_core",
                          "parity": "tensor_core", "golden_f32": "simt",
                          "serve": "tensor_core", "fleet": "tensor_core",
                          "serve_golden_f32": "simt",
                          "pretrain_step": "simt",
                          "pretrain_validate": "simt",
                          "pretrain_golden_f32": "simt",
                          "fused_wave": "tensor_core",
                          "fused_golden_f32": "simt",
                          "interventions_wave": "tensor_core",
                          "interventions_golden_f32": "simt",
                          "ensemble_wave": "tensor_core",
                          **{k: "none" for k in cli},
                          **{k: "none" for k in speaker},
                          "mesh_wave": "tensor_core",
                          "mesh_train_step": "none",
                          "mesh_pretrain_step": "simt",
                          "mesh_dp2_wave": "simt",
                          "mesh_mp2_wave": "simt (one head a rank)",
                          **{k: "none" for k in long_context}},
        "cli_note": cli_note,
        "per": "one wave of the main path (216 launches, bf16, tensor-core "
               "route)"}, {
        "name": "fused_attention", "route": "cuda",
        "source": "vln_magic_tpu_torch/csrc/fused_attention.cu",
        "replaces": "vln_magic_tpu/ops/attention.py:272",
        "launches": fused["launches"], "max_abs_err": fused["max_abs_err"],
        "ms": fused["ms"], "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"], "bound_by": by(fused),
        "library_ms": None,
        "library_note": "no single PyTorch call returns the probability map",
        "eager_ms": fused["eager_ms"], "simt_ms": fused["simt_ms"],
        "exact_limit_used": fused["exact_limit_used"],
        "tc_launches": fused["tc_launches"],
        "route_by_path": {"entry_point": "tensor_core", "f32": "simt",
                          **{k: "none" for k in cli},
                          **{k: "none" for k in speaker},
                          **{k: "none" for k in mesh},
                          **{k: "none" for k in long_context}},
        "launches_by_path": {"entry_point": fused["launches"],
                             **{"train_step" if k == "default"
                                else f"train_{k}": v["fused_attention"]
                                for k, v in train_launches.items()},
                             # phase 11 raises on any fused launch
                             "pretrain_step": 0, "pretrain_validate": 0,
                             **{k: v["fused_attention"]
                                for k, v in cli.items()},
                             **{k: v["fused_attention"]
                                for k, v in speaker.items()},
                             # phases 16-17 raise on any fused launch
                             **{k: 0 for k in mesh},
                             **{k: 0 for k in long_context}},
        "cli_note": cli_note,
        "per": "its entry point once at each of the six MAGIC-S path "
               "shapes (6 launches, bf16, tensor-core route); no model path "
               "calls it, the train step included"}, {
        "name": "observed_walk", "route": "cuda",
        "source": "vln_magic_tpu_torch/csrc/observed_walk.cu",
        "replaces": "no TPU kernel: the fori_loop walks over _observed_next "
                    "(vln_magic_tpu/agent/rollout.py:929, :1555)",
        "equal_to_loop": True,
        "by_shape": {f"{r['shape']}_seed{r['seed']}": {
            k: r[k] for k in ("B", "C", "hops", "mean_hops_taken", "ms",
                              "eager_ms", "plain_ms", "plain_eager_ms")}
            for r in walk_rows},
        "replayed": {"parity": parity_walks, **serve["walk_check"]},
        "launches_by_path": {"parity": parity_walks_launched,
                             "serve": serve["serve_walks"],
                             "fleet": serve["fleet_walks"]},
        "per": "one launch a transition of a parity or served step and one "
               "a backtrack (finish); the eval paths launch none"}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        # one rank of phase 16 (b), started by _mesh_pair
        mesh_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    else:
        main()
