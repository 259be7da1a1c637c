"""comorag_torch's corpus programs over a mesh that crosses a process
boundary (``parallel/distributed.py``; the port's counterpart of
tests/test_multihost_dcn.py).

Two processes of tests/_torch_dcn_worker.py join one gloo group on
127.0.0.1, pass 4 CPU positions each and form one ``{"corpus": 8}`` mesh;
each runs the worker's ``run(mesh)`` on inputs made from numpy seeds and
writes its results to an .npz. The job runs once per module. Every result
is held three ways:

  - the two processes' results equal each other bit for bit (the outputs
    are replicated, as JAX's are);
  - they equal the same ``run`` on a one-process 8-position CPU mesh bit
    for bit (the merge concatenates candidates in position order across
    processes), PPR ranks within 1e-6 (the flows of the two processes'
    pieces are summed in another association);
  - against JAX's same programs on the conftest's 8 virtual CPU devices
    (the kernel route's Pallas kernels in interpret mode): ids, positions,
    rankings and flags equal; scores within 1e-5 absolute, PPR ranks within
    1e-5 (the JAX worker's tolerance).
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import Mesh, RemoteDevice, build_mesh, one_process
from comorag_tpu.ops import ppr as jppr
from comorag_tpu.ops import topk as jtopk
from comorag_tpu.parallel.mesh import build_mesh as jax_build_mesh
from comorag_tpu.retrieval.index import MipsIndex as JaxIndex
from comorag_tpu.utils import trace as jax_trace

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_PATH = os.path.join(HERE, "_torch_dcn_worker.py")
spec = importlib.util.spec_from_file_location("_torch_dcn_worker", WORKER_PATH)
worker = importlib.util.module_from_spec(spec)
spec.loader.exec_module(worker)

CPU = torch.device("cpu")
N_SHARDS = worker.SHARDS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both processes' results, from one two-process job."""
    out = tmp_path_factory.mktemp("torch_dcn")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE)] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    procs = [subprocess.Popen([sys.executable, WORKER_PATH, str(port), str(pid), str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the two-process job timed out:\n" + "\n".join(logs))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_DCN_OK {pid}" in log, f"process {pid} failed:\n{log[-4000:]}"
    return [dict(np.load(out / f"rank{pid}.npz")) for pid in (0, 1)]


@pytest.fixture(scope="module")
def single():
    """The same programs on one process's 8-position CPU mesh."""
    return worker.run(build_mesh({"corpus": N_SHARDS}, [CPU] * N_SHARDS))


@pytest.fixture(scope="module")
def jmesh():
    return jax_build_mesh({"corpus": N_SHARDS}, devices=jax.devices()[:N_SHARDS])


@pytest.fixture(scope="module")
def inputs():
    return worker.inputs()


def _port(ranks, single, key, tol=None):
    """The key's result: equal on both processes, and equal to the
    one-process mesh's (bit for bit, or within ``tol``)."""
    got = ranks[0][key]
    np.testing.assert_array_equal(ranks[1][key], got, err_msg=f"{key}: the processes disagree")
    if tol is None:
        np.testing.assert_array_equal(got, single[key], err_msg=f"{key}: differs from the one-process mesh")
    else:
        assert np.abs(got - single[key]).max() < tol, key
    return got


def _pad(x, rows):
    """JAX's padded [8 * rows, ...] corpus."""
    padded = np.zeros((N_SHARDS * rows,) + x.shape[1:], x.dtype)
    padded[: len(x)] = x
    return padded


def test_the_mesh_spans_both_processes(ranks):
    """Process-major positions: rank 0 owns corpus positions 0-3, rank 1
    positions 4-7; each sees itself as one of two processes on gloo."""
    for pid, r in enumerate(ranks):
        np.testing.assert_array_equal(r["mesh/processes"], [0] * 4 + [1] * 4)
        np.testing.assert_array_equal(r["mesh/local"], [pid == 0] * 4 + [pid == 1] * 4)
        np.testing.assert_array_equal(r["mesh/process"], [pid, 2, pid, 2])
        assert str(r["mesh/backend"]) == "gloo"


@pytest.mark.parametrize("method,int8", [(m, i) for m in ("xla", "pallas") for i in (False, True)])
def test_sharded_topk_across_processes(ranks, single, jmesh, inputs, method, int8):
    """3,000 rows with row 10's copies at rows 2,500 and 2,990 (the second
    process's shards): the kernel route's layout has two empty shards on
    the second process."""
    name = f"topk/{method}/{'int8' if int8 else 'fp32'}"
    s, i = _port(ranks, single, f"{name}/scores"), _port(ranks, single, f"{name}/ids")
    x, q, rows = inputs["x"], inputs["q"], worker.TOPK_LAYOUTS[method]
    fn = jtopk.make_sharded_topk(jmesh, 10, interpret=True, method=method, int8=int8)
    if int8:
        cq, scales = jtopk.quantize_int8(x)
        sj, ij = fn(q, _pad(np.asarray(cq), rows), _pad(np.asarray(scales), rows), np.int32(len(x)))
    else:
        sj, ij = fn(q, _pad(x, rows), np.int32(len(x)))
    np.testing.assert_array_equal(i, np.asarray(ij))
    np.testing.assert_allclose(s, np.asarray(sj), atol=1e-5, rtol=0)
    assert i[0, :3].tolist() == [10, 2500, 2990]  # equal scores across the processes: lowest id first


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_sharded_two_pass_across_processes(ranks, single, jmesh, inputs, scan):
    """The duplicate cluster's query flags (its shard's pool boundary ties
    the merged k-th); the flag is reduced over the processes."""
    pre = f"two_pass/{scan}"
    s, i, flag = (_port(ranks, single, f"{pre}/{f}") for f in ("scores", "ids", "flag"))
    corpus, q, rows, k = inputs["dup"], inputs["dup_q"], 512, 16
    if scan == "int8":
        cat, s1, bound = jtopk.quantize_int8_residual(corpus)
        jargs = (_pad(np.asarray(cat), rows), _pad(np.asarray(s1), rows))
    else:
        hat, bound = jtopk.bf16_scan_corpus(corpus)
        jargs = (_pad(np.asarray(hat), rows),)
    packed = np.asarray(jtopk.make_sharded_two_pass_topk(jmesh, k, 64, scan=scan)(
        q, *jargs, _pad(corpus, rows), np.int32(len(corpus)), np.float32(bound)))
    np.testing.assert_array_equal(flag, packed[:, -1])
    assert flag.tolist() == [1] + [0] * 7
    np.testing.assert_array_equal(i[1:], packed[1:, k : 2 * k])
    np.testing.assert_allclose(s, packed[:, :k].view(np.float32), atol=1e-5, rtol=0)


def _jax_rows(inputs, int8):
    if int8:
        cq, scales = jtopk.quantize_int8(inputs["x"])
        return _pad(np.asarray(cq), 512), _pad(np.asarray(scales), 512)
    return (_pad(inputs["x"], 512),)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_sharded_topk_min_across_processes(ranks, single, jmesh, inputs, int8):
    """The row minimum is reduced by MIN; the second process's two empty
    shards add nothing."""
    pre, k, n = f"topk_min/{'int8' if int8 else 'fp32'}", 12, len(inputs["x"])
    s, i, m = (_port(ranks, single, f"{pre}/{f}") for f in ("scores", "ids", "row_min"))
    packed = np.asarray(jtopk.make_sharded_topk_min(jmesh, k, int8=int8)(inputs["q"], *_jax_rows(inputs, int8),
                                                                         np.int32(n)))
    np.testing.assert_array_equal(i, packed[:, k + 1 :])
    np.testing.assert_allclose(s, packed[:, :k].view(np.float32), atol=1e-5, rtol=0)
    np.testing.assert_allclose(m, packed[:, k].view(np.float32), atol=1e-5, rtol=0)
    assert np.isfinite(m).all()


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_sharded_scores_across_processes(ranks, single, jmesh, inputs, int8):
    full = _port(ranks, single, f"scores/{'int8' if int8 else 'fp32'}/scores")
    n = len(inputs["x"])
    assert full.shape == (8, n)
    full_j = np.asarray(jtopk.make_sharded_scores(jmesh, int8=int8)(inputs["q"], *_jax_rows(inputs, int8)))[:, :n]
    np.testing.assert_allclose(full, full_j, atol=1e-5, rtol=0)


def _graph(inputs, name):
    g = {k.split("/")[1]: v for k, v in inputs.items() if k.startswith(f"{name}/")}
    return g, jppr.PPRGraph(g["src"], g["dst"], g["w"], int(g["n"]), max_iters=256, tol=1e-8, backend="device",
                            mesh=jax_build_mesh({"corpus": N_SHARDS}, devices=jax.devices()[:N_SHARDS]))


@pytest.mark.parametrize("name", ["ring", "random"])
def test_sharded_ppr_across_processes(ranks, single, inputs, name):
    """One all_reduce SUM a step over the processes, and the stop decision
    reduced by MAX; on the ring each seed node ranks first."""
    ranks_t = _port(ranks, single, f"ppr/{name}/ranks", tol=1e-6)
    g, jgraph = _graph(inputs, name)
    assert np.abs(ranks_t - jgraph.query(g["resets"])).max() < 1e-5
    np.testing.assert_allclose(ranks_t.sum(axis=1), 1.0, atol=1e-5)
    if name == "ring":
        assert ranks_t.argmax(axis=1).tolist() == [0, 31]


@pytest.mark.parametrize("name", ["ring", "random"])
def test_sharded_ppr_seed_topk_across_processes(ranks, single, inputs, name):
    s = _port(ranks, single, f"ppr_seed_topk/{name}/scores", tol=1e-6)
    pos = _port(ranks, single, f"ppr_seed_topk/{name}/positions")
    g, jgraph = _graph(inputs, name)
    sj, pj = jgraph.query_topk(g["seed_idx"], g["seed_w"], g["prior_idx"], g["prior"], k=10)
    np.testing.assert_array_equal(pos, pj)
    assert np.abs(s - sj).max() < 1e-5


def test_ppr_graph_across_processes(ranks, single, inputs):
    """PPRGraph(mesh=): each process holds the arc pieces of its own
    positions (-1: another process's), and query / query_topk run the torch
    iteration over the process group."""
    pieces = [r["ppr_graph/pieces"] for r in ranks]
    np.testing.assert_array_equal(pieces[0][4:], [-1] * 4)
    np.testing.assert_array_equal(pieces[1][:4], [-1] * 4)
    np.testing.assert_array_equal(np.where(pieces[0] >= 0, pieces[0], pieces[1]), single["ppr_graph/pieces"])
    got = _port(ranks, single, "ppr_graph/query", tol=1e-6)
    g, jgraph = _graph(inputs, "random")
    assert np.abs(got - jgraph.query(g["resets"])).max() < 1e-5
    s = _port(ranks, single, "ppr_graph/topk_scores", tol=1e-6)
    pos = _port(ranks, single, "ppr_graph/topk_positions")
    sj, pj = jgraph.query_topk(g["seed_idx"], g["seed_w"], g["prior_idx"], g["prior"], k=10)
    np.testing.assert_array_equal(pos, pj)
    assert np.abs(s - sj).max() < 1e-5


@pytest.mark.parametrize("variant", sorted(worker.INDEX_VARIANTS))
def test_index_across_processes(ranks, single, jmesh, inputs, variant):
    """MipsIndex(mesh=) at 4,101 rows (8 shards of 520, the last 461): each
    process places its own four; topk, topk_many, topk_min, scores and
    scores_stats against JAX's sharded index."""
    pre = f"index/{variant}"
    layouts = [r[f"{pre}/layout"] for r in ranks]
    np.testing.assert_array_equal(layouts[0][:2], [N_SHARDS, 520])
    np.testing.assert_array_equal(np.where(layouts[0] >= 0, layouts[0], layouts[1]), single[f"{pre}/layout"])
    assert (layouts[0][6:] == -1).all() and (layouts[1][2:6] == -1).all()
    x, q = inputs["index_x"], inputs["index_q"]
    j = JaxIndex(x, mesh=jmesh, **worker.INDEX_VARIANTS[variant])
    assert j.n_shards == N_SHARDS

    def same(field, ref, exact=False):
        got = _port(ranks, single, f"{pre}/{field}")
        if exact:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)

    sj, ij = j.topk(q, 20)
    same("topk_ids", ij, True), same("topk_scores", sj)
    assert ranks[0][f"{pre}/topk_ids"][0, :2].tolist() == [10, 3900]
    for b, (sj, ij) in enumerate(j.topk_many([q[:3], q[3:8], q[8]], 7)):
        same(f"many{b}_ids", ij, True), same(f"many{b}_scores", sj)
    sj, ij, mj = j.topk_min_async(q, 9).result()
    same("min_ids", ij, True), same("min_scores", sj), same("min_row_min", mj)
    same("scores", j.scores(q))
    vj, ij, minj, sumj = j.scores_stats_async(q, 6).stats()
    same("stats_ids", ij, True), same("stats_vals", vj), same("stats_row_min", minj), same("stats_row_sum", sumj)


@pytest.mark.parametrize("scan", ["int8", "bfloat16"])
def test_index_rescues_across_processes(ranks, single, jmesh, inputs, scan):
    """The duplicate cluster spans both processes' shards: the query on it
    flags on both, is rescued by one fp32 pass over the mesh, and the
    flagged rows, margin and two_pass.* counter deltas equal JAX's."""
    pre = f"rescue/{scan}"
    s, i = _port(ranks, single, f"{pre}/scores"), _port(ranks, single, f"{pre}/ids")
    rows, margin = _port(ranks, single, f"{pre}/rows"), _port(ranks, single, f"{pre}/margin")
    counters = json.loads(str(_port(ranks, single, f"{pre}/counters")))
    before = {k: v for k, v in jax_trace.summary()["counters"].items() if k.startswith("two_pass.")}
    index = JaxIndex(inputs["rescue"], mesh=jmesh, scan_dtype=scan)
    h = index.topk_async(inputs["rescue_q"], 5)
    sj, ij = h.result()
    after = {k: v for k, v in jax_trace.summary()["counters"].items() if k.startswith("two_pass.")}
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_allclose(s, sj, atol=1e-5, rtol=0)
    assert rows.tolist() == h._rescue_state[0].tolist() == [0] and int(margin) == index._tie_margin
    assert counters == {c: v - before.get(c, 0) for c, v in after.items() if v != before.get(c, 0)}
    assert counters["two_pass.rescued_rows"] == 1


# --------------------------------------------------- no process group here
def test_collectives_are_the_identity_without_a_group():
    """Where no process group is initialized, one process's mesh never
    calls into torch.distributed: the collectives return their input."""
    assert not distributed.initialized() and distributed.process_count() == 1
    t = torch.arange(6.0).reshape(2, 3)
    assert distributed.all_gather_cols(t) is t
    for op in ("sum", "min", "max"):
        assert distributed.all_reduce(t, op) is t
    with pytest.raises(ValueError, match="op must be one of"):
        distributed.all_reduce(t, "mean")
    assert distributed.all_gather_object({"a": 1}) == [{"a": 1}]
    assert build_mesh({"corpus": 4}, [CPU] * 4).process_count == 1


def test_backend_is_named_never_swapped():
    """nccl is refused on the CPU before any rendezvous, an unknown backend
    too; two ranks whose cards share a UUID are refused (the check runs
    before NCCL forms its group)."""
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        distributed.initialize("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        distributed.initialize("127.0.0.1:1", 2, 0, backend="mpi", device="cpu")
    assert distributed.duplicate_cards(["GPU-a", "GPU-b", "GPU-a"]) == (0, 2)
    assert distributed.duplicate_cards(["GPU-a", "GPU-b"]) is None
    assert not distributed.initialized()


def test_card_exchange_outlives_every_read():
    """The cards are compared through the rendezvous store before NCCL
    forms its group; process 0, which holds the store, returns only after
    every process has read every card (else a process that raises closes
    the store under the other's read)."""
    import datetime
    import threading

    port, timeout = _free_port(), datetime.timedelta(seconds=30)
    master = torch.distributed.TCPStore("127.0.0.1", port, 2, is_master=True, timeout=timeout, wait_for_workers=False)
    got, read_when_rank0_returned = {}, []

    def client():
        store = torch.distributed.TCPStore("127.0.0.1", port, 2, is_master=False, timeout=timeout)
        got[1] = distributed.exchange(store, 1, 2, "GPU-a")

    def rank0():
        got[0] = distributed.exchange(master, 0, 2, "GPU-a")
        read_when_rank0_returned.append(master.check(["comorag/read/1"]))

    threads = [threading.Thread(target=rank0), threading.Thread(target=client)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert got == {0: ["GPU-a", "GPU-a"], 1: ["GPU-a", "GPU-a"]}
    assert distributed.duplicate_cards(got[0]) == (0, 1)
    assert read_when_rank0_returned == [True]


def test_one_process_parts_refuse_a_process_mesh(tmp_path):
    """The encoder's model axis and the data-axis batch split of training
    run on one process's meshes only: over a mesh that spans processes
    they raise, where the corpus programs, ComoRAG's meta loop (its
    questions in lockstep), the encoder's data axis (its own data indices'
    sub-batches) and TP generation run: the decoder's split builds this
    process's blocks alone. A position of another process holds a
    RemoteDevice, on which no tensor can be put."""
    devices = np.empty(4, dtype=object)
    devices[:] = [CPU, CPU, RemoteDevice(1, "cpu"), RemoteDevice(1, "cpu")]
    mesh = Mesh(devices.reshape(2, 2), ("data", "corpus"), np.asarray([[0, 0], [1, 1]]), 0)
    assert mesh.process_count == 2 and mesh.device == CPU
    assert mesh.is_local(data=0, corpus=1) and not mesh.is_local(data=1) and mesh.process_of(data=1) == 1
    with pytest.raises(NotImplementedError, match=r"the encoder's model axis and training \(its batch split\) run on "
                                                  "one process's meshes"):
        one_process(mesh, "the encoder's model axis")
    from comorag_torch.comorag import ComoRAG
    from comorag_torch.config import ComoConfig
    from comorag_torch.models import bge, decoder
    from comorag_torch.parallel.mesh import split_batch

    rag = ComoRAG(ComoConfig(llm_name="fake", embedding_model_name="hash", save_dir=str(tmp_path / "outputs"),
                             output_dir=str(tmp_path / "results")), mesh=mesh)
    assert rag._lockstep and rag.mesh is mesh and rag.device == CPU
    model = bge.init_params(bge.EncoderArch.tiny(), torch.Generator().manual_seed(0), "cpu")
    encoder = bge.BGETorchEncoder(params=model, max_seq_len=16, mesh=mesh)
    assert mesh.local_indices("data") == [0] and encoder._local_parts == [(0, CPU)] and encoder._across
    with pytest.raises(NotImplementedError):
        bge.shard_params(model, Mesh(devices.reshape(2, 2), ("model", "corpus"), np.asarray([[0, 0], [1, 1]]), 0))
    model_mesh = Mesh(devices.reshape(2, 2), ("model", "corpus"), np.asarray([[0, 0], [1, 1]]), 0)
    params = decoder.init_params(decoder.DecoderArch.tiny(), torch.Generator().manual_seed(0), "cpu")
    qkv = decoder.shard_params(params, model_mesh)["layers"]["qkv_w"]
    assert qkv.indices == (0,) and qkv.devices == (CPU,) and len(qkv.shards) == 1
    whole = params["layers"]["qkv_w"]
    assert torch.equal(qkv.shards[0], whole[..., : whole.shape[-1] // 2])
    with pytest.raises(NotImplementedError):
        split_batch({"x": torch.zeros(4, 2)}, mesh)
    with pytest.raises(TypeError):
        torch.zeros(2, device=mesh.at(data=1))
