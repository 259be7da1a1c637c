"""Encoder finetuning CLI: (query, passage) pairs -> contrastive train ->
checkpoint + serving-ready parameters.

Port of ``comorag_tpu/cli/train.py``: the same flags, batch sampling
(passage-unique pairs drawn with ``np.random.default_rng(seed)``),
tokenization and summary. The checkpoint is a ``torch.save`` file
(``models.train.save_checkpoint``); its parameters load straight into the
serving encoder (``BGETorchEncoder(params=...)``), whatever mesh trained
it. ``--device`` picks the card (the default) or ``cpu``; ``--mesh_shape
data=2,model=2`` trains over a mesh (``models.train.make_train_step(mesh=)``)
of every card with ``--device cuda`` (too few raise) or of the CPU repeated
with ``--device cpu``. ``--init random`` draws from ``torch.Generator``, so
its weights differ from the JAX CLI's for the same seed.

Input: pairs.jsonl with {"query": ..., "passage": ...} per line.

Usage:
  python -m comorag_torch.cli.train --pairs pairs.jsonl --output_dir ckpt \\
      [--init hf:<local checkpoint> | random | tiny] [--steps 200] [--batch 32] \\
      [--lr 2e-5] [--max_seq_len 128] [--mesh_shape data=8] [--compute_dtype bfloat16] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from comorag_torch.models.bge import EncoderArch, SimpleHashTokenizer, init_params, load_hf_checkpoint, shard_params
from comorag_torch.models.train import (
    TrainState,
    make_optimizer,
    make_train_step,
    save_checkpoint,
)
from comorag_torch.parallel.mesh import device_mesh, mesh_device, parse_mesh_shape
from comorag_torch.utils.jsonio import load_jsonl
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


def main(argv: List[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs", required=True, help="jsonl of {query, passage}")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--init", default="random",
                    help="'random', 'tiny', or 'hf:<local checkpoint path>'")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--weight_decay", type=float, default=0.01)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--max_seq_len", type=int, default=128)
    ap.add_argument("--mesh_shape", default="",
                    help="e.g. data=8 or data=4,model=2: every card with --device cuda, the CPU repeated with cpu")
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    if args.steps <= 0:
        raise SystemExit("--steps must be >= 1")
    mesh = device_mesh(parse_mesh_shape(args.mesh_shape), args.device) if args.mesh_shape else None
    device = mesh_device(mesh, args.device)
    pairs = load_jsonl(args.pairs)
    if not pairs:
        raise SystemExit(f"no pairs in {args.pairs}")
    queries = [p["query"] for p in pairs]
    passages = [p["passage"] for p in pairs]

    tokenizer = None
    if args.init.startswith("hf:"):
        params, arch = load_hf_checkpoint(args.init[3:], device)
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.init[3:])
    else:
        arch = EncoderArch.tiny() if args.init == "tiny" else EncoderArch()
        params = init_params(arch, torch.Generator().manual_seed(args.seed), device)
    tokenizer = tokenizer or SimpleHashTokenizer(arch.vocab_size)
    if mesh is not None:
        params = shard_params(params, mesh)

    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    step_fn = make_train_step(arch, temperature=args.temperature, compute_dtype=compute_dtype, mesh=mesh)
    state = TrainState(params, make_optimizer(args.lr, args.weight_decay)(params), 0)

    def tokenize(texts: List[str]) -> tuple:
        if isinstance(tokenizer, SimpleHashTokenizer):
            rows, masks = tokenizer(texts, args.max_seq_len)
        else:
            out = tokenizer(texts, padding=False, truncation=True, max_length=args.max_seq_len)
            rows, masks = out["input_ids"], out["attention_mask"]
        ids = np.zeros((len(texts), args.max_seq_len), np.int64)
        mask = np.zeros((len(texts), args.max_seq_len), np.int64)
        for i, (r, m) in enumerate(zip(rows, masks)):
            r, m = r[: args.max_seq_len], m[: args.max_seq_len]
            ids[i, : len(r)] = r
            mask[i, : len(m)] = m
        mask[mask.sum(axis=1) == 0, 0] = 1  # avoid 0/0 pooling on empty rows
        return ids, mask

    rng = np.random.default_rng(args.seed)
    losses: List[float] = []
    # a contrastive batch must not repeat a passage TEXT (a duplicate
    # positive is an unwinnable in-batch negative), so sample within
    # passage-unique index groups
    unique_pair_idx: Dict[str, int] = {}
    for i, p_text in enumerate(passages):
        unique_pair_idx.setdefault(p_text, i)
    pool = np.asarray(sorted(unique_pair_idx.values()))
    batch_size = min(args.batch, len(pool))
    if batch_size < min(args.batch, len(pairs)):
        print(f"note: {len(pairs) - len(pool)} pairs share passages; "
              f"batches sample from {len(pool)} passage-unique pairs")
    t0 = time.perf_counter()
    for step in range(args.steps):
        take = rng.choice(pool, size=batch_size, replace=False)
        q_ids, q_mask = tokenize([queries[i] for i in take])
        p_ids, p_mask = tokenize([passages[i] for i in take])
        batch = {name: torch.as_tensor(arr, device=device) for name, arr in
                 (("q_ids", q_ids), ("q_mask", q_mask), ("p_ids", p_ids), ("p_mask", p_mask))}
        state, loss = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss_val = float(loss)  # sync point — only at log intervals
            losses.append(loss_val)
            logger.info("step %d/%d loss %.4f", step + 1, args.steps, loss_val)

    wall = time.perf_counter() - t0
    os.makedirs(args.output_dir, exist_ok=True)
    save_checkpoint(os.path.join(args.output_dir, "train_state"), state)
    summary = {
        "steps": args.steps,
        "pairs": len(pairs),
        "first_loss": losses[0],
        "final_loss": losses[-1],
        "pairs_per_s": round(args.steps * batch_size / wall, 1),
        "arch": {"hidden": arch.hidden_size, "layers": arch.num_layers},
        "checkpoint": os.path.join(args.output_dir, "train_state"),
    }
    with open(os.path.join(args.output_dir, "train_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
