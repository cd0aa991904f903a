"""Smoke run of vln_magic_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Four phases, each printing one JSON line; any failure raises and exits
non-zero:

1. card and build: the card's name and power limit, the torch and CUDA
   versions, and the time to build the CUDA kernel from
   vln_magic_tpu_torch/csrc/ with nvcc for sm_90a;
2. kernel vs plain: ``packed_attention`` on the card against its plain
   PyTorch version at every shape of the main path (B 256, H 2, hd 64) and
   at edge shapes, in f32 (2e-5 absolute) and bf16 (5e-2 absolute), with
   the kernel's time, its bound, the plain version's time and, as a
   yardstick only, ``scaled_dot_product_attention`` on the same inputs;
3. golden decode: the pinned tests/golden_decode.json trajectories, in f32
   with the kernel on, from the weights in tests/fixtures/;
4. main path: ``Navigator.evaluate`` on 256 items at MAGIC-S full width
   (hidden 128, 2 heads, 6/2/3 layers, CLIP-768 features, 200-token
   instructions, gmap 128, T 15, 3 scans x 320 nodes), bf16, random
   weights from a seed; the kernel must launch 216 times per wave.

Then the per-kernel summary line, the card line, and the result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

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
MAIN_BATCH, MAIN_T = 256, 15


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
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


def phase_card_and_build(card):
    from vln_magic_tpu_torch.ops import attention

    t0 = time.perf_counter()
    attention.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(card, flush=True)
    emit({"phase": "card_and_build", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s})


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
              ("hd128", 2, 1, 5, 33, 128, True, True, 0)]
    summary = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "max_abs_err": 0.0}
    for seed, (name, b, h, lq, lk, hd, sprel, masked, per_wave) in \
            enumerate(cases):
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            q, k, v, mask, sp = make_inputs(b, h, lq, lk, hd, dtype, sprel,
                                            seed, masked)
            want = ref(q, k, v, mask, sp, h)
            attention.packed_attention_reference = plain_must_not_run
            try:
                got = pa(q, k, v, mask, sp, num_heads=h)
                torch.cuda.synchronize()
                ms = time_ms(lambda: pa(q, k, v, mask, sp, num_heads=h))
            finally:
                attention.packed_attention_reference = ref
            err = (got.float() - want.float()).abs().max().item()
            if not (torch.isfinite(got).all() and err <= tol):
                raise AssertionError(f"{name} {dtype}: max abs err {err} "
                                     f"> {tol}")
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
                  "sprel": sprel, "dtype": str(dtype).split(".")[-1],
                  "max_abs_err": err, "tol": tol, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "launches_per_wave": per_wave, "card": card})
            if dtype == torch.bfloat16 and per_wave:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms),
                                 ("library_ms", lib_ms),
                                 ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    summary[key] += per_wave * val
                summary["max_abs_err"] = max(summary["max_abs_err"], err)

    # malformed input raises instead of reaching either version
    q, k, v, mask, _ = make_inputs(2, 2, 4, 4, 24, torch.float32, False, 0)
    try:
        pa(q, k, v, mask, None, num_heads=2)
    except ValueError:
        pass
    else:
        raise AssertionError("head dim 24 was accepted")
    return summary


def golden_config():
    from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig,
                                            ModelConfig, TrainConfig)

    return MagicConfig(
        model=ModelConfig(vocab_size=400, hidden_size=64,
                          num_attention_heads=2, num_l_layers=2,
                          num_pano_layers=1, num_x_layers=2,
                          image_feat_size=24, max_position_embeddings=64,
                          use_pallas_attention=True),
        env=EnvConfig(max_action_len=8, max_gmap_len=24, max_instr_len=48),
        train=TrainConfig(batch_size=8, compute_dtype="float32"))


def phase_golden(card):
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions
    from vln_magic_tpu_torch.ops.attention import packed_attention

    world = make_synthetic_world(num_scans=2, nodes_per_scan=20, feat_dim=24,
                                 seed=777)
    flat = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                     "golden_params_777.npz")))
    nav = Navigator(golden_config(), world, params=flat, device="cuda")
    items = make_synthetic_instructions(world, 8, np.random.default_rng(777),
                                        vocab_size=400, min_path=3,
                                        max_path=6)
    before = packed_attention.launches
    (_, _), preds = nav.evaluate(items, batch_size=8)
    got = [p["trajectory_idx"] for p in preds]
    with open(os.path.join(ROOT, "tests", "golden_decode.json")) as f:
        want = json.load(f)
    for ep, (g, w) in enumerate(zip(got, want)):
        if g != w:
            step = next(i for i in range(max(len(g), len(w)))
                        if i >= len(g) or i >= len(w) or g[i] != w[i])
            raise AssertionError(f"golden decode differs at episode {ep}, "
                                 f"step {step}: {g} vs {w}")
    if len(got) != len(want):
        raise AssertionError("golden decode episode count differs")
    emit({"phase": "golden_decode", "episodes": len(got), "match": True,
          "kernel_launches": packed_attention.launches - before,
          "card": card})


def build_main_path():
    """The full-width MAGIC-S navigator on the card, its world and 256
    items: (navigator, items, set-up seconds)."""
    from vln_magic_tpu_torch.agent.navigator import Navigator
    from vln_magic_tpu_torch.config import (EnvConfig, MagicConfig,
                                            ModelConfig, TrainConfig)
    from vln_magic_tpu_torch.env import make_synthetic_world
    from vln_magic_tpu_torch.env.synthetic import make_synthetic_instructions

    batch, t_steps, txt_len = MAIN_BATCH, MAIN_T, 200
    cfg = MagicConfig(
        model=ModelConfig(hidden_size=128, num_attention_heads=2,
                          num_l_layers=6, num_pano_layers=2, num_x_layers=3,
                          image_feat_size=768, use_pallas_attention=True),
        env=EnvConfig(max_action_len=t_steps, max_gmap_len=128,
                      max_instr_len=txt_len),
        train=TrainConfig(batch_size=batch, compute_dtype="bfloat16"))
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


def phase_main_path(card):
    from vln_magic_tpu_torch.ops.attention import packed_attention

    batch, t_steps = MAIN_BATCH, MAIN_T
    nav, items, setup_s = build_main_path()
    world = nav.world
    nav.evaluate(items)                 # warm-up: cuBLAS handles, caches
    torch.cuda.synchronize()
    packed_attention.launches = 0
    t0 = time.perf_counter()
    (avg, _), preds = nav.evaluate(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = packed_attention.launches

    waves = math.ceil(len(items) / batch)
    if launches != LAUNCHES_PER_WAVE * waves:
        raise AssertionError(f"packed_attention launched {launches} times, "
                             f"want {LAUNCHES_PER_WAVE} x {waves}")
    if len(preds) != len(items) or not all(
            math.isfinite(v) for v in avg.values()):
        raise AssertionError(f"bad evaluation output: {avg}")
    for p, it in zip(preds, items):
        g = world.graphs[p["scan_idx"]]
        flat = [n for seg in p["trajectory_idx"] for n in seg]
        if flat[0] != it["path_idx"][0] or not all(
                g.adjacency[a, b] for a, b in zip(flat[:-1], flat[1:])):
            raise AssertionError(f"trajectory off the graph: {flat}")
    emit({"phase": "main_path", "batch": batch, "waves": waves,
          "T": t_steps, "setup_s": setup_s, "wall_s": wall,
          "semantic_steps_per_s": avg["semantic_steps"] / wall,
          "padded_steps_per_s": batch * waves * t_steps / wall,
          "metrics": avg, "kernels": {"packed_attention": launches},
          "card": card})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import vln_magic_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    phase_card_and_build(card)
    summary = phase_kernel_vs_plain(card)
    phase_golden(card)
    launches = phase_main_path(card)
    emit({"kernels": [{
        "name": "packed_attention", "route": "cuda",
        "source": "vln_magic_tpu_torch/csrc/packed_attention.cu",
        "replaces": "vln_magic_tpu/ops/attention.py:216",
        "launches": launches, "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"], "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": ("bytes" if summary["bytes_ms"] >= summary["ops_ms"]
                     else "operations"),
        "library_ms": summary["library_ms"],
        "per": "one wave of the main path (216 launches, bf16)"}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
