"""Where a training step's time goes on the card: torch.profiler over the
port's two training steps at chip_smoke.py phase 12's shapes.

    python scripts/torch_train_profile.py [--steps 3] [--out build/train_profile.json]

For each case (the bert-base contrastive step at B = 32, S = 128 in fp32
and in bf16 compute; the causal-LM step at Llama-3.1-8B width cut to 2
layers, B = 4, S = 512, bf16 compute, remat), two warm-up steps, then
``--steps`` timed steps without the profiler (the wall per step: host
clock, synchronized), then ``--steps`` profiled steps: the device's busy
time per step (the union of the CUDA kernels' intervals on the timeline;
user annotations such as ``Optimizer.step`` are not kernels and are left
out), the idle share (1 - busy / unprofiled wall), the kernel launches per
step, and the ten kernels with the most device time. Each case runs a
second time over ``chip_smoke.py`` phase 15's ``{"data": 2, "model": 2}``
mesh, every position on the card (``<case>_mesh``). Needs a CUDA card; prints one JSON line per case and writes
them all to ``--out``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from comorag_torch.models import bge, decoder, train, train_lm  # noqa: E402
from comorag_torch.parallel.mesh import build_mesh  # noqa: E402

MESH_SHAPE = {"data": 2, "model": 2}  # chip_smoke.py phase 15's mesh


def encoder_case(device, compute_dtype, mesh=None):
    arch = bge.EncoderArch()
    state = train.create_train_state(arch, torch.Generator().manual_seed(0), device=None if mesh else device,
                                     mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {}
    for side in ("q", "p"):
        batch[f"{side}_ids"] = torch.randint(2, arch.vocab_size, (32, 128), generator=gen, device=device)
        lengths = torch.randint(8, 40, (32,), generator=gen, device=device)  # chunk-length texts, padded to 128
        batch[f"{side}_mask"] = (torch.arange(128, device=device)[None] < lengths[:, None]).long()
    return state, train.make_train_step(arch, compute_dtype=compute_dtype, mesh=mesh), batch


def lm_case(device, mesh=None):
    arch = decoder.DecoderArch(vocab_size=128256, hidden_size=4096, num_layers=2, num_heads=32, num_kv_heads=8,
                               intermediate_size=14336, max_seq_len=131072, rope_theta=500000.0,
                               rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0))
    params = decoder.init_params(arch, torch.Generator(device=device).manual_seed(0), device)
    if mesh is not None:
        params = decoder.shard_params(params, mesh)
    state = train.TrainState(params, train.make_optimizer(1e-4)(params), 0)
    ids = torch.randint(1, arch.vocab_size, (4, 512), generator=torch.Generator(device=device).manual_seed(1),
                        device=device)
    mask = torch.ones_like(ids)
    mask[2:, 400:] = 0
    return state, train_lm.make_lm_train_step(arch, compute_dtype=torch.bfloat16, mesh=mesh), \
        {"ids": ids, "mask": mask}


def busy_us(events) -> float:
    """The union of the CUDA kernels' intervals (µs): kernels that overlap
    count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def profile(name, state, step, batch, steps: int) -> dict:
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state, loss = step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_us(kernels) / 1e6 / steps
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"case": name, "wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3, "idle_share": 1 - busy / wall,
            "kernel_launches_per_step": len(kernels) / steps, "loss": float(loss),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="build/train_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    meshes = {"": None, "_mesh": build_mesh(MESH_SHAPE, [device] * math.prod(MESH_SHAPE.values()))}
    rows = []
    for (name, make), (tag, mesh) in itertools.product(
            (("encoder_fp32", lambda m: encoder_case(device, torch.float32, m)),
             ("encoder_bf16", lambda m: encoder_case(device, torch.bfloat16, m)),
             ("lm_8b_width_2_layers_bf16", lambda m: lm_case(device, m))), meshes.items()):
        row = profile(name + tag, *make(mesh), args.steps)
        if mesh is not None:
            row["mesh"] = mesh.shape
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
