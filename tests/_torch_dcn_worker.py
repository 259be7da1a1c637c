"""Worker of tests/test_torch_dcn.py: comorag_torch's corpus programs over a
mesh whose ``corpus`` axis crosses a process boundary (the port's twin of
tests/_dcn_worker.py).

    python tests/_torch_dcn_worker.py PORT PROCESS_ID OUT_DIR [MODE]

Two such processes join one gloo group at 127.0.0.1:PORT
(``parallel/distributed.initialize``); each passes 4 CPU positions and
together they form one ``{"corpus": 8}`` mesh, rank 0's positions first.
Both run ``run(mesh)`` (every input made from numpy seeds by ``inputs()``)
and write its results to OUT_DIR/rank<PROCESS_ID>.npz. The test calls the
same ``run`` on a one-process 8-position CPU mesh and holds JAX's programs
against the same inputs. On cards (MODE, ``tests/test_torch_cuda.py``)
they run ``run_card`` instead. This file imports neither jax nor
comorag_tpu, and checks so at its end.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from comorag_torch.ops import ppr as tppr
from comorag_torch.ops import topk as ttopk
from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import build_mesh, is_local_device, shard_bounds
from comorag_torch.retrieval.index import MipsIndex
from comorag_torch.utils import trace

D = 64
SHARDS = 8
CPU = torch.device("cpu")
# rows a shard of the sharded top-k layouts: the XLA route's 8-row
# rounding (3,000 rows: 376 x 7 + 368) and the kernel route's 512-row tiles
# (512 x 5 + 440 + two empty shards, both on the second process)
TOPK_LAYOUTS = {"xla": 376, "pallas": 512}
INDEX_VARIANTS = {"auto": {}, "fp32": {"scan_dtype": None}, "int8": {"dtype": "int8"},
                  "bf16_scan": {"scan_dtype": "bfloat16"}}
PPR_TOL = 1e-7  # the fp32 floor PPRGraph applies (ops/ppr.py ``_tol``)


def _normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _exact_duplicate_corpus(n, dups, seed=5):
    """``dups`` exact copies of one row at the front and low fillers
    (tests/test_torch_parallel.py)."""
    rng = np.random.default_rng(seed)
    base = _normalized(rng, (D,))
    fillers = _normalized(rng, (n - dups, D)) / 4.0
    return np.concatenate([np.tile(base, (dups, 1)), fillers], axis=0).astype(np.float32)


def _ring(n=96):
    ring = np.arange(n, dtype=np.int32)
    return (np.concatenate([ring, (ring + 1) % n]), np.concatenate([(ring + 1) % n, ring]),
            np.ones(2 * n, np.float32), n)


def _random_graph(n=500, e=3000, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
            rng.random(e).astype(np.float32), n)


def inputs() -> dict:
    """Every input of ``run``, from fixed numpy seeds."""
    x = _normalized(np.random.default_rng(0), (3000, D))
    for row in (2500, 2990):  # equal scores across the process boundary
        x[row] = x[10]
    out = {"x": x, "q": np.concatenate([x[10:11], _normalized(np.random.default_rng(1), (7, D))])}
    dup = _exact_duplicate_corpus(4090, dups=300)
    away = _normalized(np.random.default_rng(3), (7, D))
    away -= (away @ dup[0])[:, None] * dup[0] + 0.5 * dup[0]  # the duplicates rank last
    out.update(dup=dup, dup_q=np.concatenate([dup[0][None] * 2.0, away]).astype(np.float32))
    index_x = _normalized(np.random.default_rng(6), (4101, D))
    index_x[3900] = index_x[10]
    out.update(index_x=index_x,
               index_q=np.concatenate([index_x[10:11], _normalized(np.random.default_rng(7), (8, D))]))
    rescue = _exact_duplicate_corpus(4096, dups=2100)  # the duplicates reach shard 4, on the second process
    q_dup = rescue[0] / np.linalg.norm(rescue[0])
    out.update(rescue=rescue, rescue_q=np.stack([q_dup, -q_dup, rescue[3000] * 4.0]).astype(np.float32))
    for name, (src, dst, w, n) in (("ring", _ring()), ("random", _random_graph())):
        rng = np.random.default_rng(3)
        if name == "ring":
            resets = np.zeros((2, n), np.float32)
            resets[0, 0] = resets[1, 31] = 1.0
        else:
            resets = (rng.random((5, n)) * (rng.random((5, n)) > 0.9)).astype(np.float32)
        b = len(resets)
        out.update({f"{name}/src": src, f"{name}/dst": dst, f"{name}/w": w, f"{name}/n": np.int64(n),
                    f"{name}/resets": resets,
                    f"{name}/seed_idx": rng.integers(n // 3, n, (b, 8)).astype(np.int32),
                    f"{name}/seed_w": (rng.random((b, 8)) * (rng.random((b, 8)) > 0.3)).astype(np.float32),
                    f"{name}/prior_idx": np.arange(n // 3, dtype=np.int64),
                    f"{name}/prior": rng.random((b, n // 3)).astype(np.float32) * 0.005})
    return out


def place(mesh, x: np.ndarray, rows: int) -> list:
    """``x``'s rows over the mesh's corpus positions in the even split of
    ``rows`` a shard: a tensor at this process's positions, None at the
    others."""
    return [torch.as_tensor(x[r.start : r.stop]).to(dev) if is_local_device(dev) else None
            for r, dev in zip(shard_bounds(len(x), SHARDS, rows), mesh.axis_devices("corpus"))]


def _counters() -> dict:
    return {k: v for k, v in trace.summary()["counters"].items() if k.startswith("two_pass.")}


def run(mesh) -> dict:
    """Every corpus program over ``mesh`` ({"corpus": 8}) on ``inputs()``:
    a flat dict of numpy results, the same keys on every process."""
    a = inputs()
    out = {}
    q = torch.as_tensor(a["q"])
    for method, rows in TOPK_LAYOUTS.items():
        for int8 in (False, True):
            name = f"topk/{method}/{'int8' if int8 else 'fp32'}"
            fn = ttopk.make_sharded_topk(mesh, 10, method=method, int8=int8, shard_rows=rows)
            if int8:
                cq, scales = ttopk.quantize_int8(a["x"])
                s, i = fn(q, place(mesh, cq, rows), place(mesh, scales, rows))
            else:
                s, i = fn(q, place(mesh, a["x"], rows))
            out[f"{name}/scores"], out[f"{name}/ids"] = s.numpy(), i.numpy()

    dq, bound_rows = torch.as_tensor(a["dup_q"]), 512
    for scan in ("int8", "bfloat16"):
        if scan == "int8":
            cat, s1, bound = ttopk.quantize_int8_residual(a["dup"])
            scan_shards, scale_shards = place(mesh, cat, bound_rows), place(mesh, s1, bound_rows)
        else:
            hat, bound = ttopk.bf16_scan_corpus(a["dup"])
            scan_shards, scale_shards = place(mesh, hat, bound_rows), None
        s, i, flag = ttopk.make_sharded_two_pass_topk(mesh, 16, 64, shard_rows=bound_rows)(
            dq, scan_shards, scale_shards, place(mesh, a["dup"], bound_rows), torch.tensor(bound, dtype=torch.float32))
        out.update({f"two_pass/{scan}/scores": s.numpy(), f"two_pass/{scan}/ids": i.numpy(),
                    f"two_pass/{scan}/flag": flag.numpy()})

    for int8 in (False, True):
        tag = "int8" if int8 else "fp32"
        if int8:
            cq, scales = ttopk.quantize_int8(a["x"])
            args = (place(mesh, cq, 512), place(mesh, scales, 512))
        else:
            args = (place(mesh, a["x"], 512),)
        s, i, m = ttopk.make_sharded_topk_min(mesh, 12, int8=int8, shard_rows=512)(q, *args)
        out.update({f"topk_min/{tag}/scores": s.numpy(), f"topk_min/{tag}/ids": i.numpy(),
                    f"topk_min/{tag}/row_min": m.numpy(),
                    f"scores/{tag}/scores": ttopk.make_sharded_scores(mesh, int8=int8)(q, *args).numpy()})

    for name in ("ring", "random"):
        g = {k.split("/")[1]: v for k, v in a.items() if k.startswith(f"{name}/")}
        graph = tppr.PPRGraph(g["src"], g["dst"], g["w"], int(g["n"]), mesh=mesh, max_iters=256, tol=1e-8,
                              backend="device")
        normed = torch.as_tensor(g["resets"] / g["resets"].sum(axis=1, keepdims=True))
        out[f"ppr/{name}/ranks"] = tppr.make_sharded_ppr(mesh, 256)(graph._arcs, graph._dangling, normed, 0.5,
                                                                    PPR_TOL).numpy()
        s, pos = tppr.make_sharded_ppr_seed_topk(mesh, 256, 10)(
            graph._arcs, graph._dangling, torch.as_tensor(g["seed_idx"], dtype=torch.int64),
            torch.as_tensor(g["seed_w"]), torch.as_tensor(g["prior_idx"]), torch.as_tensor(g["prior"]), 0.5, PPR_TOL)
        out[f"ppr_seed_topk/{name}/scores"], out[f"ppr_seed_topk/{name}/positions"] = s.numpy(), pos.numpy()
        if name == "random":
            out["ppr_graph/query"] = graph.query(g["resets"])
            s, pos = graph.query_topk(g["seed_idx"], g["seed_w"], g["prior_idx"], g["prior"], k=10)
            out["ppr_graph/topk_scores"], out["ppr_graph/topk_positions"] = s, pos
            out["ppr_graph/pieces"] = np.asarray([len(p[0]) if p is not None else -1 for p in graph._arcs])

    iq = a["index_q"]
    for variant, kw in INDEX_VARIANTS.items():
        ix = MipsIndex(a["index_x"], mesh=mesh, **kw)
        pre = f"index/{variant}"
        out[f"{pre}/layout"] = np.asarray([ix.n_shards, ix.shard_rows]
                                          + [len(c) if c is not None else -1 for c in ix.corpus])
        out[f"{pre}/topk_scores"], out[f"{pre}/topk_ids"] = ix.topk(iq, 20)
        for b, (s, i) in enumerate(ix.topk_many([iq[:3], iq[3:8], iq[8]], 7)):
            out[f"{pre}/many{b}_scores"], out[f"{pre}/many{b}_ids"] = s, i
        for field, value in zip(("scores", "ids", "row_min"), ix.topk_min_async(iq, 9).result()):
            out[f"{pre}/min_{field}"] = value
        out[f"{pre}/scores"] = ix.scores(iq)
        for field, value in zip(("vals", "ids", "row_min", "row_sum"), ix.scores_stats_async(iq, 6).stats()):
            out[f"{pre}/stats_{field}"] = value

    for scan in ("int8", "bfloat16"):
        before = _counters()
        ix = MipsIndex(a["rescue"], mesh=mesh, scan_dtype=scan)
        h = ix.topk_async(a["rescue_q"], 5)
        s, i = h.result()
        after = _counters()
        delta = {c: v - before.get(c, 0) for c, v in after.items() if v != before.get(c, 0)}
        out.update({f"rescue/{scan}/scores": s, f"rescue/{scan}/ids": i,
                    f"rescue/{scan}/rows": np.asarray(h._rescue_state[0]),
                    f"rescue/{scan}/margin": np.int64(ix._tie_margin),
                    f"rescue/{scan}/counters": np.asarray(json.dumps(delta, sort_keys=True))})
    return out


def run_card(mesh) -> dict:
    """The kernel routes, the default two-pass and PPR over ``mesh`` on
    cards (``tests/test_torch_cuda.py``): each top-k call's kernel launches
    on this process beside its results."""
    from comorag_torch.ops import mips

    rng = np.random.default_rng(7)
    corpus, q = _normalized(rng, (SHARDS * 1500, 256)), _normalized(rng, (16, 256))
    out = {}
    for name, kw, counter in (("pallas_fp32", {"method": "pallas"}, mips.LAUNCHES),
                              ("pallas_int8", {"method": "pallas", "dtype": "int8"}, mips.INT8_LAUNCHES),
                              ("two_pass", {}, None)):
        ix = MipsIndex(corpus, mesh=mesh, **kw)
        before = counter.value if counter is not None else 0
        out[f"{name}/scores"], out[f"{name}/ids"] = ix.topk(q, 50)
        out[f"{name}/launches"] = np.int64(counter.value - before if counter is not None else 0)
    src, dst = rng.integers(0, 5000, 60_000), rng.integers(0, 5000, 60_000)
    resets = (rng.random((8, 5000)) * (rng.random((8, 5000)) > 0.99)).astype(np.float32) + 1e-6
    graph = tppr.PPRGraph(src, dst, rng.random(60_000).astype(np.float32), 5000, mesh=mesh, backend="device")
    out["ppr/ranks"] = graph.query(resets)
    return out


def _card_positions(mode: str, pid: int) -> list:
    """Four positions a process: all on cuda:0 under gloo; under nccl on
    this process's half of the cards (its first card first)."""
    if mode == "gloo-cuda":
        return [torch.device("cuda", 0)] * 4
    per = torch.cuda.device_count() // 2
    return [torch.device("cuda", pid * per + j % per) for j in range(4)]


def main(argv) -> None:
    """argv: PORT PROCESS_ID OUT_DIR [MODE]; MODE "cpu" (the default: the
    CPU programs), "gloo-cuda" (both processes on cuda:0), "nccl" (each
    process on its own cards) or "nccl-one-card" (both on cuda:0 under
    nccl, which must be refused)."""
    port, pid, out_dir = argv[1], int(argv[2]), argv[3]
    mode = argv[4] if len(argv) > 4 else "cpu"
    torch.set_num_threads(2)
    address = f"127.0.0.1:{port}"
    if mode == "nccl-one-card":
        try:
            distributed.initialize(address, 2, pid, backend="nccl", device="cuda:0", timeout_s=60)
        except ValueError as e:
            print(f"TORCH_DCN_REFUSED {pid}: {e}", flush=True)
            return
        raise SystemExit("nccl with two ranks on one card was not refused")
    if mode == "cpu":
        distributed.initialize(address, 2, pid, device="cpu", timeout_s=60)
        positions = [CPU] * 4
    else:
        positions = _card_positions(mode, pid)
        distributed.initialize(address, 2, pid, backend="gloo" if mode == "gloo-cuda" else "nccl",
                               device=positions[0], timeout_s=60)
    try:
        mesh = build_mesh({"corpus": SHARDS}, positions)
        results = run(mesh) if mode == "cpu" else run_card(mesh)
        results["mesh/processes"] = mesh.processes.ravel()
        results["mesh/local"] = np.asarray([mesh.is_local(corpus=i) for i in range(SHARDS)])
        results["mesh/process"] = np.asarray([distributed.process_index(), distributed.process_count(),
                                              mesh.process_index, mesh.process_count])
        results["mesh/backend"] = np.asarray(distributed.backend())
        np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **results)
    finally:
        distributed.shutdown()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "comorag_tpu"))
    if loaded:
        raise SystemExit(f"the worker loaded {loaded[:5]}")
    print(f"TORCH_DCN_OK {pid}", flush=True)


if __name__ == "__main__":
    main(sys.argv)
