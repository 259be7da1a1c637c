"""The tf32 scan route's arithmetic emulated on the CPU at chip_smoke.py
phase 6's shape (bench.py's normalized 100,000 x 1024 corpus, seed 0,
P = 16 queries, k = 50): the max |score - float64| of the returned top-k,
as phase 6 and ``scripts/exp_topk_variants.py`` read it on the card, for
each sum order (one accumulator; the cross terms in a second one) and each
rounding of the mma's fp32 sum (to nearest; toward zero). Compare with the
card's own error to see which rounding its tensor cores use.

    python scripts/tf32_emulation_error.py [--queries 16] [--threads 4]

CPU only (the emulation is ``tests/_tf32_emulation.py``, which
``tests/test_torch_mips.py`` tests); ~2 GB of host memory and about a
minute at the defaults.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from _tf32_emulation import ROUNDINGS, tf32_scores  # noqa: E402

N, D, K = 100_000, 1024, 50  # bench.py:34-37


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    rng = np.random.default_rng(0)  # chip_smoke.bench_data's draws, in its order
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((args.queries, D)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    exact = torch.as_tensor(queries.astype(np.float64) @ corpus.astype(np.float64).T)
    q, c = torch.as_tensor(queries), torch.as_tensor(corpus)
    for rounding in sorted(ROUNDINGS):
        for cross_sum in (False, True):
            scores, ids = torch.topk(tf32_scores(q, c, cross_sum, rounding), K, dim=1)
            err = float((scores.double() - exact.gather(1, ids)).abs().max())
            order = "cross terms in a second sum" if cross_sum else "one sum"
            print(f"P={args.queries} rounding {rounding}, {order}: max |top-{K} score - float64| = {err:.3g}",
                  flush=True)


if __name__ == "__main__":
    main()
