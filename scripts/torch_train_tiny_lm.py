"""Training recipe for the hermetic tiny decoder checkpoint, on the PyTorch
port.

Port of ``scripts/train_tiny_lm.py``: the same ~6M-parameter byte-vocab
llama-class decoder (``build_arch``), the same synthetic curriculum
(``models/curriculum.py``), AdamW under the same warmup-cosine schedule,
fp32 compute with per-layer recomputation, then the same per-task
evaluation of greedy generation (``evaluate``) on the checkpoint reloaded
from its fp16 file. It trains on the card (``--device cuda``, the default,
which raises without one) or on the CPU (``--device cpu``), and writes
``build/tiny_lm_torch.npz`` unless ``--out`` says otherwise: the committed
``assets/tiny_lm.npz``, which ``jax-tiny`` serves, is the JAX package's.
The file is ``curriculum.save_tiny_checkpoint``'s, so either package
loads it.

Usage:
  python scripts/torch_train_tiny_lm.py [--steps 3000] [--batch 16] [--seq 2048] [--out build/tiny_lm_torch.npz]
  # CPU smoke:  --device cpu --steps 4 --batch 2 --seq 256
  # evaluate a checkpoint:  --eval_only --out <file>;  warm-start:  --init <file>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from comorag_torch.device import resolve_device  # noqa: E402
from comorag_torch.llm.offline import TorchOfflineLLM  # noqa: E402
from comorag_torch.models import curriculum as cur  # noqa: E402
from comorag_torch.models.decoder import DecoderArch  # noqa: E402
from comorag_torch.models.train import TrainState, make_optimizer, warmup_cosine_decay_schedule, whole_leaves  # noqa: E402
from comorag_torch.models.train_lm import create_lm_train_state, make_lm_train_step  # noqa: E402

DEFAULT_OUT = os.path.join(REPO, "build", "tiny_lm_torch.npz")


def build_arch(seq_len: int) -> DecoderArch:
    return DecoderArch(
        vocab_size=259,
        hidden_size=256,
        num_layers=6,  # byte-level needle retrieval wants induction depth
        num_heads=8,
        num_kv_heads=4,
        intermediate_size=1024,
        max_seq_len=seq_len,
    )


def make_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """Warmup from 0 to ``lr`` over min(100, steps // 10 + 1) steps, then a
    cosine decay to ``lr * 0.05`` at ``steps``."""
    return warmup_cosine_decay_schedule(0.0, lr, warmup_steps=min(100, steps // 10 + 1), decay_steps=steps,
                                        end_value=lr * 0.05)


def create_state(arch: DecoderArch, lr: float, steps: int, seed: int, device: torch.device,
                 init: Optional[str] = None) -> TrainState:
    """fp32 weights from ``decoder.init_params`` with a generator on
    ``device`` seeded by ``seed`` (or a warm start from the checkpoint
    ``init``, which must have the same arch) and the scheduled AdamW with
    JAX's decay mask, at step 0."""
    state = create_lm_train_state(arch, torch.Generator(device=device).manual_seed(seed),
                                  make_optimizer(learning_rate=make_schedule(lr, steps)), device=device)
    if init:
        params0, arch0 = cur.load_tiny_checkpoint(init)
        if arch0 != arch:
            raise ValueError(f"warm-start arch mismatch: {init} has {arch0}, the recipe {arch}")
        saved = dict(whole_leaves(params0))
        with torch.no_grad():
            for name, p in whole_leaves(state.params):
                p.copy_(torch.from_numpy(saved[name]))
    return state


def host_batch(rng: np.random.Generator, batch: int, seq: int, pin: bool) -> Dict[str, torch.Tensor]:
    """One curriculum batch on the host, in pinned memory for the card: a
    copy from pageable memory would wait for the stream."""
    tensors = {k: torch.from_numpy(v) for k, v in cur.sample_batch(rng, batch, seq).items()}
    return {k: v.pin_memory() for k, v in tensors.items()} if pin else tensors


def train(state: TrainState, step_fn, steps: int, batch: int, seq: int, seed: int, device: torch.device,
          log: Callable[[str], None] = print) -> Tuple[TrainState, dict]:
    """``steps`` steps on ``cur.sample_batch(np.random.default_rng(seed +
    1), batch, seq)``. The host makes the next batch while the device runs
    the last step: batches are copied from pinned memory without blocking,
    each loss is written into a device buffer, and the loss is read (a
    sync) only on the steps that print it, every 100 and the last. Returns
    the state and the run's wall, tokens/s, host batch-making ms a step
    and every step's loss."""
    rng = np.random.default_rng(seed + 1)
    pin = device.type == "cuda"
    losses = torch.zeros(steps, device=device)
    host_s = 0.0
    t0 = time.perf_counter()
    for step in range(steps):
        h0 = time.perf_counter()
        host = host_batch(rng, batch, seq, pin)
        host_s += time.perf_counter() - h0
        state, loss = step_fn(state, {k: v.to(device, non_blocking=True) for k, v in host.items()})
        losses[step] = loss
        if step % 100 == 0 or step == steps - 1:
            value = float(loss)
            elapsed = time.perf_counter() - t0
            log(f"step {step:5d}  loss {value:.4f}  ({elapsed:.0f}s)  {(step + 1) * batch * seq / elapsed:.0f} tok/s")
    losses = losses.cpu()  # waits for the last step
    wall = time.perf_counter() - t0
    return state, {"steps": steps, "wall_s": wall, "steps_per_s": steps / wall,
                   "tokens_per_s": steps * batch * seq / wall, "host_batch_ms": host_s / steps * 1e3,
                   "losses": losses.tolist()}


# ------------------------------------------------------------------- evaluate
def score_ner(samples: List[dict], texts: List[str]) -> Dict[str, float]:
    """Guided NER: the share of outputs that parse, and the entity recall
    of those that do."""
    ok, recall = 0, []
    for s, t in zip(samples, texts):
        try:
            got = json.loads(t)["named_entities"]
            ok += 1
        except (ValueError, KeyError, TypeError):  # not JSON, or not the template's object
            continue
        gold = json.loads(s["completion"])["named_entities"]
        recall.append(len(set(got) & set(gold)) / max(1, len(gold)))
    return {"ner_parse_rate": ok / len(samples),
            "ner_entity_recall": float(np.mean(recall)) if recall else 0.0}


def score_triples(samples: List[dict], texts: List[str]) -> Dict[str, float]:
    """Guided triples: parse rate, the share with a non-empty list, and the
    recall of gold subjects among the non-empty ones."""
    ok, yield_n, subj_hit = 0, 0, []
    for s, t in zip(samples, texts):
        try:
            got = json.loads(t)["triples"]
            ok += 1
        except (ValueError, KeyError, TypeError):  # not JSON, or not the template's object
            continue
        if got:
            yield_n += 1
            gold_subjects = {tr[0] for tr in json.loads(s["completion"])["triples"]}
            subj_hit.append(
                len({g[0] for g in got if len(g) == 3} & gold_subjects) / max(1, len(gold_subjects))
            )
    return {"triples_parse_rate": ok / len(samples), "triples_nonempty_rate": yield_n / len(samples),
            "triples_subject_recall": float(np.mean(subj_hit)) if subj_hit else 0.0}


def score_qa(samples: List[dict], texts: List[str]) -> Dict[str, float]:
    """QA: the share that writes ``### Final Answer``, and the share whose
    answer holds the gold span (``*`` where the gold answer is ``*``)."""
    marker, exact = 0, 0
    for s, t in zip(samples, texts):
        gold = str(s["completion"]).rsplit("### Final Answer", 1)[1].strip()
        if "### Final Answer" in t:
            marker += 1
            pred = t.rsplit("### Final Answer", 1)[1].strip()
            if gold == "*":
                exact += int(pred.startswith("*"))
            else:
                exact += int(gold.lower() in pred.lower())
    return {"qa_marker_rate": marker / len(samples), "qa_answer_rate": exact / len(samples)}


# (task, guided template, max new tokens, scoring), in the order the samples are drawn
EVAL_TASKS = (("ner", "ner", 256, score_ner), ("triples", "triples", 256, score_triples),
              ("qa", None, 384, score_qa))


def evaluate(params, arch: DecoderArch, n_per_task: int = 12, seed: int = 987654, device="cuda") -> dict:
    """Greedy-generation eval on held-out samples: parse rates, entity
    recall, triple yield, QA final-answer accuracy."""
    engine = TorchOfflineLLM(params=params, arch=arch, temperature=0.0, max_new_tokens=384, device=device)
    rng = np.random.default_rng(seed)
    out = {}
    for task, template, max_tokens, score in EVAL_TASKS:
        samples = [cur.make_sample(rng, task) for _ in range(n_per_task)]
        texts = [r.text for r in engine._generate_batch([s["prompt"] for s in samples], max_tokens, template, 0.0)]
        out.update(score(samples, texts))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--eval_only", action="store_true",
                    help="evaluate the existing --out checkpoint, no training")
    ap.add_argument("--init", default=None,
                    help="warm-start from an existing checkpoint (same arch)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.eval_only:
        params, arch = cur.load_tiny_checkpoint(args.out)
        print(json.dumps(evaluate(params, arch, device=device), indent=2))
        return

    arch = build_arch(args.seq)
    state = create_state(arch, args.lr, args.steps, args.seed, device, args.init)
    n_params = sum(p.numel() for _, p in whole_leaves(state.params))
    print(f"params: {n_params/1e6:.2f}M  seq={args.seq} batch={args.batch}", flush=True)
    state, _ = train(state, make_lm_train_step(arch), args.steps, args.batch, args.seq, args.seed, device,
                     log=lambda line: print(line, flush=True))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    cur.save_tiny_checkpoint(args.out, state.params, arch)
    print(f"saved {args.out} ({os.path.getsize(args.out)/1e6:.1f} MB)")

    # post-save eval uses the RELOADED checkpoint so fp16 storage is
    # covered by the reported numbers
    params2, arch2 = cur.load_tiny_checkpoint(args.out)
    print(json.dumps(evaluate(params2, arch2, device=device), indent=2))


if __name__ == "__main__":
    main()
