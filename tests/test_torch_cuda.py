"""comorag_torch's Hopper kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: these build the CUDA sources with nvcc and skip
where no card is visible (a CUDA kernel has no interpret mode on the CPU).

Run on a machine with an H100: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: bf16 2e-2 (the compute dtype's resolution at these magnitudes,
as tests/test_tpu_compiled.py holds the TPU kernels).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ragged_mask(b, s, rng):
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    return (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)


# every case has a ragged mask; S = 512, 32, 1, 130 and S that are no multiple
# of the 128- or 64-key tile; dh=20: the plain-load path (dh % 8 != 0);
# dh=24, 32, 160: head dims zero-padded to the 64-column swizzle atom
@pytest.mark.parametrize("b,s,heads,dh", [(2, 64, 2, 64), (3, 40, 4, 32), (2, 128, 12, 64),
                                          (2, 70, 2, 20), (2, 100, 3, 24), (1, 96, 2, 160),
                                          (2, 512, 2, 64), (4, 32, 12, 64), (3, 1, 2, 64), (2, 130, 2, 64),
                                          (2, 300, 3, 32), (2, 257, 2, 20), (1, 333, 2, 160)])
def test_encoder_attention_kernel_matches_plain(cuda_device, b, s, heads, dh):
    from comorag_torch.ops import attention

    rng = np.random.default_rng(0)
    h = heads * dh
    q, k, v = (torch.tensor(rng.standard_normal((b, s, h)), dtype=torch.bfloat16, device=cuda_device)
               for _ in range(3))
    mask = torch.tensor(_ragged_mask(b, s, rng), device=cuda_device)
    before = attention.LAUNCHES.value
    got = attention.encoder_attention(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert attention.LAUNCHES.value == before + 1
    ref = attention.encoder_attention_plain(q, k, v, mask, heads)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


def _ffn_inputs(rng, n, h, inter, device):
    def t(shape, scale=1.0, dtype=torch.float32):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device=device)

    xres = t((n, h), dtype=torch.bfloat16)
    w1 = t((h, inter), 0.05, torch.bfloat16)
    w2 = t((inter, h), 0.05, torch.bfloat16)
    s1, n1, s2, n2 = 1.0 + t((h,), 0.1), t((h,), 0.1), 1.0 + t((h,), 0.1), t((h,), 0.1)
    b1, b2 = t((inter,), 0.1), t((h,), 0.1)
    return xres, s1, n1, w1, b1, w2, b2, s2, n2


# ragged row counts (no multiple of the 128-row tile), hidden sizes that are
# no multiple of the tile's columns (128, 384), and plans with and without K
# splits of the second product (on 132 SMs: 4,100 rows at h >= 768 fill the
# card unsplit; the others split)
@pytest.mark.parametrize("n,h,inter", [(128, 128, 256), (100, 256, 512), (40, 384, 256), (64, 768, 3072),
                                       (77, 1024, 4096)]
                         + [(n, h, 4 * h) for n in (77, 1000, 4100) for h in (128, 384, 768, 1024)])
def test_encoder_ffn_kernel_matches_plain(cuda_device, n, h, inter):
    from comorag_torch.ops import ffn

    args = _ffn_inputs(np.random.default_rng(1), n, h, inter, cuda_device)
    before = ffn.LAUNCHES.value
    got = ffn.encoder_ffn(*args)
    torch.cuda.synchronize()
    assert ffn.LAUNCHES.value == before + 1
    ref = ffn.encoder_ffn_plain(*args)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)
    plan = ffn.ffn_plan(n, h, inter, ffn._sm_count(cuda_device), *ffn._tiles())
    split_ref = ffn.encoder_ffn_split_plain(*args, plan["bounds"])
    np.testing.assert_allclose(got.float().cpu().numpy(), split_ref.float().cpu().numpy(),
                               atol=2e-2, rtol=2e-2)


# the library called with each split count, whatever the plan would choose
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 48])
def test_encoder_ffn_every_split_count_matches_plain(cuda_device, splits):
    from comorag_torch.ops import build, ffn

    n, h, inter = 300, 768, 3072
    args = _ffn_inputs(np.random.default_rng(2), n, h, inter, cuda_device)
    lib = ffn._lib()
    out = torch.empty_like(args[0])
    x1 = torch.empty(n, h, dtype=torch.bfloat16, device=cuda_device)
    mid = torch.empty(n, inter, dtype=torch.bfloat16, device=cuda_device)
    part = torch.empty(splits, n, h, device=cuda_device)
    rc = lib.comorag_encoder_ffn_bf16(*(a.data_ptr() for a in args), out.data_ptr(), x1.data_ptr(),
                                      mid.data_ptr(), part.data_ptr(), n, h, inter, splits, 1e-12,
                                      ffn._sm_count(cuda_device), torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "encoder_ffn")
    torch.cuda.synchronize()
    ref = ffn.encoder_ffn_split_plain(*args, ffn.split_bounds(inter, ffn._tiles()[2], splits))
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), atol=2e-2, rtol=2e-2)


def _normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _launched(mips, route, fn):
    """fn()'s result; asserts that it launched once, on ``route``."""
    before = {r: c.value for r, c in mips.ROUTE_LAUNCHES.items()}
    out = fn()
    torch.cuda.synchronize()
    assert {r: c.value - before[r] for r, c in mips.ROUTE_LAUNCHES.items()} == {
        r: int(r == route) for r in mips.SCAN_ROUTES}
    return out


# the tie-tolerant rule of ops/mips.check_topk: scores to 1e-5 + 1e-5*|plain|,
# ids equal wherever the plain ranking is separated by more than 1e-5; int8
# rows with k <= 64 and d % 16 == 0 take the bf16 tensor-core scan ("mma": at
# bench shape d = 1024, k = 50, P = 16 and 256, and at P = 33, d = 768,
# k = 64), fp32 rows with k <= 64 the 3xTF32 one ("tf32"), k = 65 the narrow
# scan
@pytest.mark.parametrize("n", [511, 4096, 70_001])
@pytest.mark.parametrize("p,d,k", [(1, 64, 1), (5, 768, 50), (16, 64, 256), (130, 768, 50),
                                   (16, 768, 256), (130, 64, 1), (16, 1024, 50), (256, 1024, 50),
                                   (33, 768, 64), (16, 1024, 65)])
def test_mips_topk_kernels_match_plain(cuda_device, n, p, d, k):
    from comorag_torch.ops import mips
    from comorag_torch.ops.topk import dense_scores, int8_scores, quantize_int8

    rng = np.random.default_rng(n + p + d + k)
    corpus = _normalized(rng, (n, d))
    k = min(k, n)
    q = torch.tensor(_normalized(rng, (p, d)), device=cuda_device)
    c32 = torch.tensor(corpus, device=cuda_device)
    before = mips.LAUNCHES.value
    s, i = _launched(mips, mips.scan_route(p, d, k, torch.float32, True), lambda: mips.mips_topk(q, c32, k))
    assert mips.LAUNCHES.value == before + 1
    mips.check_topk(s, i, dense_scores(q, c32), "fp32")
    c16 = c32.to(torch.bfloat16)
    s, i = _launched(mips, "scan", lambda: mips.mips_topk(q, c16, k))
    mips.check_topk(s, i, dense_scores(q, c16), "bf16")
    cq, sc = (torch.tensor(a, device=cuda_device) for a in quantize_int8(corpus))
    route = "mma" if k <= 64 and d % 16 == 0 else "scan"
    assert mips.scan_route(p, d, k, torch.int8, True) == route
    before = mips.INT8_LAUNCHES.value
    s, i = _launched(mips, route, lambda: mips.mips_topk_int8(q, cq, sc, k))
    assert mips.INT8_LAUNCHES.value == before + 1
    mips.check_topk(s, i, int8_scores(q, cq, sc), "int8")


# d % 4 != 0: the scalar load path; fp32 rows at d = 64, 100 and 1024 with
# k <= 64 (1 and 40 queries at d = 64): the tf32 tensor-core scan; int8 rows
# at d = 64 and 1024 with k <= 64: the bf16 tensor-core scan
@pytest.mark.parametrize("d,p", [(3, 1), (64, 1), (100, 1), (64, 40), (1024, 16)])
def test_mips_topk_duplicates_tie_to_lowest_id(cuda_device, d, p):
    from comorag_torch.ops import mips
    from comorag_torch.ops.topk import quantize_int8

    rng = np.random.default_rng(d)
    corpus = _normalized(rng, (5000, d)) * 0.25
    dup_ids = np.sort(rng.choice(5000, 300, replace=False))
    corpus[dup_ids] = corpus[dup_ids[0]] * 4.0
    q = torch.tensor(np.repeat(corpus[dup_ids[:1]] * 2.0, p, axis=0), device=cuda_device)
    for k in (1, 40, 64, 256):
        c32 = torch.tensor(corpus, device=cuda_device)
        route = "tf32" if k <= 64 and d % 4 == 0 else "scan"
        _, i = _launched(mips, route, lambda: mips.mips_topk(q, c32, k))
        np.testing.assert_array_equal(i.cpu().numpy(), np.tile(dup_ids[:k], (p, 1)))
        cq, sc = (torch.tensor(a, device=cuda_device) for a in quantize_int8(corpus))
        route = "mma" if k <= 64 and d % 16 == 0 else "scan"
        _, i = _launched(mips, route, lambda: mips.mips_topk_int8(q, cq, sc, k))
        np.testing.assert_array_equal(i.cpu().numpy(), np.tile(dup_ids[:k], (p, 1)))


@pytest.fixture(scope="module")
def tf32_corpora():
    """Normalized fp32 corpora on the card by (N, d), made once (seeded)."""
    made = {}

    def get(n, d):
        if (n, d) not in made:
            gen = torch.Generator(device="cuda").manual_seed(n + d)
            x = torch.randn(n, d, generator=gen, device="cuda")
            made[(n, d)] = x / x.norm(dim=1, keepdim=True)
        return made[(n, d)]
    return get


# every P of the tf32 route's tile fill (1 query, one n8 tile, two, a second
# 32-query block, eight), d no multiple of its 32-feature stage (100, 1000),
# N of one split, of several, and with a ragged last tile (100,003)
@pytest.mark.parametrize("n", [600, 5000, 100_003])
@pytest.mark.parametrize("k", [1, 50, 64])
@pytest.mark.parametrize("d", [64, 100, 1000, 1024])
@pytest.mark.parametrize("p", [1, 8, 16, 33, 256])
def test_mips_topk_tf32_route_matches_plain(cuda_device, tf32_corpora, p, d, k, n):
    from comorag_torch.ops import mips
    from comorag_torch.ops.topk import dense_scores

    c32 = tf32_corpora(n, d)
    gen = torch.Generator(device="cuda").manual_seed(p + d + k)
    q = torch.randn(p, d, generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    assert mips.scan_route(p, d, k, torch.float32, True) == "tf32"
    s, i = _launched(mips, "tf32", lambda: mips.mips_topk(q, c32, k))
    mips.check_topk(s, i, dense_scores(q, c32), f"tf32 P={p} d={d} k={k} N={n}")


def test_pallas_index_routes_through_the_kernels(cuda_device):
    from comorag_torch.ops import mips
    from comorag_torch.retrieval.index import MipsIndex

    rng = np.random.default_rng(3)
    corpus = _normalized(rng, (3000, 64))
    q = _normalized(rng, (7, 64))
    plain = MipsIndex(corpus, device="cpu", scan_dtype=None)
    for dtype, counter in (("float32", mips.LAUNCHES), ("int8", mips.INT8_LAUNCHES)):
        index = MipsIndex(corpus, device=cuda_device, dtype=dtype, method="pallas")
        assert index.method == "pallas"
        before = counter.value
        s, i = index.topk(q, 10)
        assert counter.value == before + 1
        if dtype == "float32":
            s_ref, i_ref = plain.topk(q, 10)
            np.testing.assert_array_equal(i, i_ref)
            np.testing.assert_allclose(s, s_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pallas_index_over_a_mesh_launches_once_per_shard(cuda_device, dtype):
    """MipsIndex(mesh=[cuda] x 4, method="pallas") at 2,100 rows: shards of
    1,024, 1,024, 52 and 0 rows (the 512 x 4 rounding), so each call
    launches the kernel three times (the empty shard launches nothing),
    on the same scan route as one device, with the unsharded kernel
    route's ids and scores (to 1e-5)."""
    from comorag_torch.ops import mips
    from comorag_torch.parallel.mesh import build_mesh
    from comorag_torch.retrieval.index import MipsIndex

    rng = np.random.default_rng(5)
    corpus = _normalized(rng, (2100, 64))
    q = _normalized(rng, (16, 64))
    mesh = build_mesh({"corpus": 4}, [cuda_device] * 4)
    sharded = MipsIndex(corpus, mesh=mesh, dtype=dtype, method="pallas")
    single = MipsIndex(corpus, device=cuda_device, dtype=dtype, method="pallas")
    assert sharded.n_shards == 4 and [len(c) for c in sharded.corpus] == [1024, 1024, 52, 0]
    counter = mips.LAUNCHES if dtype == "float32" else mips.INT8_LAUNCHES
    route = "tf32" if dtype == "float32" else "mma"
    before, route_before = counter.value, mips.ROUTE_LAUNCHES[route].value
    s, i = sharded.topk(q, 50)
    assert counter.value == before + 3 and mips.ROUTE_LAUNCHES[route].value == route_before + 3
    s_ref, i_ref = single.topk(q, 50)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, atol=1e-5, rtol=0)


def test_mesh_over_distinct_cards_matches_one_card(cuda_device, tmp_path):
    """A corpus mesh over every visible card (needs two or more): the
    sharded kernel routes, the two-pass and the edge-sharded PPR equal one
    card's results; a {"data": n} encoder launches both kernels on each
    card and equals one card's rows to cosine 0.999; ComoRAG over the cards
    ranks as one card does. Each shard's work runs on its own card (the
    kernels' C entries launch on the current device, which the programs
    set per shard)."""
    from comorag_torch.comorag import ComoRAG
    from comorag_torch.config import ComoConfig
    from comorag_torch.models import bge
    from comorag_torch.ops import attention, ffn, mips
    from comorag_torch.ops.ppr import PPRGraph
    from comorag_torch.parallel.mesh import build_mesh
    from comorag_torch.retrieval.index import MipsIndex

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards (a mesh over distinct devices)")
    mesh = build_mesh({"corpus": n})
    assert [d.index for d in mesh.axis_devices("corpus")] == list(range(n))
    rng = np.random.default_rng(7)
    corpus = _normalized(rng, (n * 1500, 256))
    q = _normalized(rng, (16, 256))
    for kw, counter in ((dict(method="pallas"), mips.LAUNCHES), (dict(method="pallas", dtype="int8"),
                                                                mips.INT8_LAUNCHES), (dict(), None)):
        sharded, single = MipsIndex(corpus, mesh=mesh, **kw), MipsIndex(corpus, device=cuda_device, **kw)
        assert sharded.n_shards == n and [c.device.index for c in sharded.corpus] == list(range(n))
        before = counter.value if counter is not None else 0
        s, i = sharded.topk(q, 50)
        if counter is not None:
            assert counter.value == before + n
        s_ref, i_ref = single.topk(q, 50)
        np.testing.assert_array_equal(i, i_ref)
        np.testing.assert_allclose(s, s_ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(sharded.scores(q), single.scores(q), atol=1e-5, rtol=0)

    src, dst = rng.integers(0, 5000, 60_000), rng.integers(0, 5000, 60_000)
    w = rng.random(60_000).astype(np.float32)
    resets = (rng.random((8, 5000)) * (rng.random((8, 5000)) > 0.99)).astype(np.float32) + 1e-6
    graphs = [PPRGraph(src, dst, w, 5000, backend="device", **kw) for kw in ({"mesh": mesh}, {"device": cuda_device})]
    assert [a[0].device.index for a in graphs[0]._arcs] == list(range(n))
    assert np.abs(graphs[0].query(resets) - graphs[1].query(resets)).max() < 1e-6

    arch = bge.EncoderArch(vocab_size=512, num_layers=2, max_position=128)
    params = bge.init_params(arch, torch.Generator().manual_seed(0), device="cpu")
    texts = [f"the keeper lit lamp number {i} at dusk" + " again" * (i % 7) for i in range(40)]
    data = bge.BGETorchEncoder(params=params, max_seq_len=64, compute_dtype=torch.bfloat16,
                               mesh=build_mesh({"data": n}))
    one = bge.BGETorchEncoder(params=params, max_seq_len=64, compute_dtype=torch.bfloat16, device=cuda_device)
    assert data.attention == "kernel" and sorted(d.index for d in data._replicas) == list(range(n))
    before = (attention.LAUNCHES.value, ffn.LAUNCHES.value)
    got = torch.as_tensor(data.encode(texts))
    # 2 batches x 2 layers, on each of the n cards
    assert attention.LAUNCHES.value - before[0] == ffn.LAUNCHES.value - before[1] == 2 * 2 * n
    ref = torch.as_tensor(one.encode(texts))
    assert float(torch.nn.functional.cosine_similarity(got, ref, dim=1).min()) >= 0.999

    chunks = [f"Record {i}: entry number {i} of the ledger, kept at the mill." for i in range(n * 600)]
    chunks[777] = "Record 777: Quintessa hid the moonstone crown inside the old cistern."
    config = ComoConfig(llm_name="fake", embedding_model_name="hash", embedding_dim=64, need_cluster=False,
                        save_dir=str(tmp_path / "o"), output_dir=str(tmp_path / "r"), max_meta_loop_iterations=1)
    rag = ComoRAG(config, mesh=mesh)
    rag.index(chunks)
    engine = rag.engine
    engine.prepare()
    assert engine.ver_index.n_shards == n
    qe = engine.encode_queries(["Who hid the moonstone crown?"])["passage"]
    np.testing.assert_array_equal(engine.ver_index.topk(qe, 20)[1],
                                  MipsIndex(rag.ver_store.matrix, device=cuda_device).topk(qe, 20)[1])
    assert "cistern" in rag.try_answer(["Who hid the moonstone crown in the cistern?"])[0].answer


def test_dryrun_multichip_over_four_distinct_cards(cuda_device):
    """The port's ``dryrun_multichip(4)`` ({"data": 2, "model": 2}) over
    cuda:0-3 against the same call over [cuda:0] * 4: the training losses
    within rtol 1e-5 (tests/test_torch_train_mesh.py's rule; one seed draws
    the same weights on every layout), the corpus-sharded top-k ids equal,
    the PPR sums within 1e-5 relative, text from every engine call, and on
    each layout ``int4_matmul`` launched as ``decoder.product_route``
    routes each split (one launch a shard over distinct cards)."""
    from comorag_torch import graft_entry

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a data x model mesh over distinct devices)")
    cards = graft_entry.dryrun_multichip(4, [torch.device("cuda", i) for i in range(4)])
    one = graft_entry.dryrun_multichip(4, [torch.device("cuda", 0)] * 4)
    assert cards["devices"] == [f"cuda:{i}" for i in range(4)] and one["devices"] == ["cuda:0"] * 4
    np.testing.assert_allclose(cards["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(cards["lm_loss"], one["lm_loss"], rtol=1e-5)
    assert cards["topk_ids"] == one["topk_ids"]
    np.testing.assert_allclose(cards["ppr_sum"], one["ppr_sum"], rtol=1e-5)
    for run in (cards, one):
        assert all(isinstance(text, str) for text in run["texts"].values()), run["texts"]
        assert run["int4_matmul_launches"] == run["int4_matmul_per_forward"] * run["int4_decode_steps"] > 0
        assert not any(run["train_launches"].values())


def _two_processes(tmp_path, mode: str, worker: str = "_torch_dcn_worker.py") -> list:
    """tests/``worker`` in two processes (``mode``: its card modes): their
    logs, after both ended within 240 s (else both are killed and the test
    fails)."""
    import os
    import socket
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, worker), str(port), str(pid),
                               str(tmp_path), mode], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for pid in (0, 1)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the two-process {mode} job timed out")
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid} failed:\n{log[-4000:]}"
    return logs


def _one_process_on_one_card() -> dict:
    """The worker's ``run_card`` on one process's mesh of 8 positions on
    cuda:0; the top-k kernels are built here, so the two processes only
    load them."""
    import importlib.util
    import os

    from comorag_torch.ops import build
    from comorag_torch.parallel.mesh import build_mesh

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dcn_worker.py")
    spec = importlib.util.spec_from_file_location("_torch_dcn_worker", path)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    build.load_all(["mips_topk"])
    return worker.run_card(build_mesh({"corpus": 8}, [torch.device("cuda", 0)] * 8))


def _held_against_one_process(tmp_path, ref):
    """Both processes' results equal each other and one process's mesh
    (ids and scores bit for bit, PPR ranks within 1e-6); each process
    launched each top-k kernel once per local shard: 4 a call."""
    got = [dict(np.load(tmp_path / f"rank{pid}.npz")) for pid in (0, 1)]
    for key, value in ref.items():
        for r in got:
            if key == "ppr/ranks":
                assert np.abs(r[key] - value).max() < 1e-6
            elif key.endswith("/launches"):
                assert int(r[key]) == (4 if key.startswith("pallas") else 0) and int(value) == 2 * int(r[key])
            else:
                np.testing.assert_array_equal(r[key], value, err_msg=key)
    return got


def test_process_mesh_gloo_on_one_card_matches_one_process(cuda_device, tmp_path):
    """Two processes on cuda:0 under gloo, 4 positions each ({"corpus": 8});
    the kernel routes launch on each process's shards alone. nccl asked for
    with both ranks on cuda:0 is refused in both processes, never swapped
    for gloo."""
    ref = _one_process_on_one_card()
    _two_processes(tmp_path, "gloo-cuda")
    got = _held_against_one_process(tmp_path, ref)
    assert all(str(r["mesh/backend"]) == "gloo" for r in got)
    logs = _two_processes(tmp_path, "nccl-one-card")
    assert all(f"TORCH_DCN_REFUSED {pid}" in log and "same card" in log for pid, log in enumerate(logs))


def test_process_mesh_nccl_over_distinct_cards_matches_one_card(cuda_device, tmp_path):
    """Two processes under nccl, each on its own half of the cards (2 each
    on four cards, 1 each on two), 4 positions a process, held against one
    card's mesh of 8 positions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards (one NCCL rank a card)")
    ref = _one_process_on_one_card()
    _two_processes(tmp_path, "nccl")
    got = _held_against_one_process(tmp_path, ref)
    assert all(str(r["mesh/backend"]) == "nccl" for r in got)


def _meta_loop_one_process(tmp_path) -> dict:
    """tests/_torch_dcn_meta_worker.py's ``run_corpus`` (index, retrieve and
    answer 12 questions) on one process's {"corpus": 8} mesh of cuda:0."""
    import importlib.util
    import os

    from comorag_torch.parallel.mesh import build_mesh

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dcn_meta_worker.py")
    spec = importlib.util.spec_from_file_location("_torch_dcn_meta_worker", path)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    return worker.run_corpus(build_mesh({"corpus": 8}, [torch.device("cuda", 0)] * 8), str(tmp_path / "one"))


def _meta_loop_held_against_one_process(tmp_path, mode: str) -> list:
    """The meta loop across two processes (``mode``) on the CPU test's
    corpus: answers, tri_retrieve docs and veridical ids equal in both
    processes and to one process's mesh, scores within 1e-6."""
    ref = _meta_loop_one_process(tmp_path)
    logs = _two_processes(tmp_path, mode, "_torch_dcn_meta_worker.py")
    assert all(f"TORCH_DCN_META_OK {pid}" in log for pid, log in enumerate(logs))
    got = [dict(np.load(tmp_path / f"rank{pid}.npz")) for pid in (0, 1)]
    for r in got:
        for key in ("a/answers", "a/docs", "a/ver_ids", "a/shards"):
            np.testing.assert_array_equal(r[key], ref[key], err_msg=key)
        assert np.abs(r["a/ver_scores"] - ref["a/ver_scores"]).max() < 1e-6
    assert len(ref["a/answers"]) == 12 and all(ref["a/answers"])
    return got


def test_meta_loop_process_mesh_gloo_on_one_card_matches_one_process(cuda_device, tmp_path):
    """ComoRAG over {"corpus": 8} across two processes on cuda:0 under
    gloo, 4 positions each, the questions in lockstep."""
    got = _meta_loop_held_against_one_process(tmp_path, "gloo-cuda")
    assert all(str(r["backend"]) == "gloo" for r in got)


def test_meta_loop_process_mesh_nccl_over_distinct_cards(cuda_device, tmp_path):
    """The same under nccl, 2 cards a process on four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (2 a process under nccl)")
    got = _meta_loop_held_against_one_process(tmp_path, "nccl")
    assert all(str(r["backend"]) == "nccl" for r in got)


def test_kernels_reject_what_they_do_not_take(cuda_device):
    from comorag_torch.ops import attention, ffn

    q = torch.zeros(2, 16, 128, device=cuda_device)  # fp32: the kernel is bf16-only
    with pytest.raises(TypeError):
        attention.encoder_attention(q, q, q, torch.ones(2, 16, device=cuda_device), 2)
    x = torch.zeros(32, 96, dtype=torch.bfloat16, device=cuda_device)  # hidden 96
    w1 = torch.zeros(96, 256, dtype=torch.bfloat16, device=cuda_device)
    w2 = torch.zeros(256, 96, dtype=torch.bfloat16, device=cuda_device)
    v96 = torch.zeros(96, device=cuda_device)
    with pytest.raises(ValueError):
        ffn.encoder_ffn(x, v96, v96, w1, torch.zeros(256, device=cuda_device), w2, v96, v96, v96)

    from comorag_torch.ops import mips

    corpus = torch.zeros(1000, 64, device=cuda_device)
    with pytest.raises(ValueError):  # k above the kernels' 256
        mips.mips_topk(torch.zeros(2, 64, device=cuda_device), corpus, 257)
    with pytest.raises(TypeError):  # fp64 rows
        mips.mips_topk(torch.zeros(2, 64, device=cuda_device), corpus.double(), 5)
    # the C entry refuses a route outside its limits (fp32 rows on the int8
    # tensor-core scan; bf16 rows, and k = 65, on the tf32 scan) instead of
    # taking another
    lib, sms = mips._lib(), mips._sm_count(cuda_device)
    q = torch.zeros(2, 64, device=cuda_device)
    ws = torch.empty(lib.comorag_mips_topk_workspace_bytes(2, 1000, 64, 65, sms), dtype=torch.uint8,
                     device=cuda_device)
    out_s, out_i = torch.empty(2, 65, device=cuda_device), torch.empty(2, 65, dtype=torch.int64, device=cuda_device)
    c16 = corpus.to(torch.bfloat16)
    for route, rows, bf16, k in (("mma", corpus, 0, 5), ("tf32", c16, 1, 5), ("tf32", corpus, 0, 65)):
        rc = lib.comorag_mips_topk(q.data_ptr(), rows.data_ptr(), bf16, 2, 1000, 64, k, mips.SCAN_ROUTES.index(route),
                                   sms, ws.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        assert rc != 0, (route, rows.dtype, k)


# ------------------------------------------------------------------ training
def _step_on(device, kind):
    """One training step at a tiny width from the same CPU-drawn weights and
    batch: (loss, gradients by name, loss after the step)."""
    from comorag_torch.models import bge, decoder, train, train_lm

    rng = np.random.default_rng(4)
    if kind == "encoder":
        arch = bge.EncoderArch.tiny()
        params = bge.init_params(arch, torch.Generator().manual_seed(0), device=device)
        batch = {k: torch.as_tensor(rng.integers(2, arch.vocab_size, (8, 16)), device=device) for k in ("q_ids", "p_ids")}
        for side in ("q", "p"):
            lengths = torch.as_tensor(rng.integers(3, 17, size=8), device=device)
            batch[f"{side}_mask"] = (torch.arange(16, device=device)[None] < lengths[:, None]).long()

        def loss_fn(p):
            return train.contrastive_loss(p, batch, arch)

        step = train.make_train_step(arch)
    else:
        arch = decoder.DecoderArch.tiny(vocab_size=64)
        params = decoder.params_from_jax(decoder.init_params(arch, torch.Generator().manual_seed(0), device="cpu"),
                                         device)
        mask = torch.ones(4, 24, dtype=torch.int64)
        mask[:, 20:] = 0
        batch = {"ids": torch.as_tensor(rng.integers(1, 64, (4, 24)), device=device), "mask": mask.to(device)}

        def loss_fn(p):
            return train_lm.lm_loss(p, batch, arch)

        step = train_lm.make_lm_train_step(arch)
    state = train.TrainState(params, train.make_optimizer(1e-3, 0.1)(params), 0)
    state, loss = step(state, batch)
    grads = {name: p.grad.cpu() for name, p, _ in train.named_leaves(params)}
    with torch.no_grad():
        after = loss_fn(state.params)
    return float(loss), grads, float(after)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_training_step_on_the_card_matches_the_cpu(cuda_device, kind):
    """fp32 with TF32 off (device.py) on both: the loss to rtol 1e-4, the
    gradients to rtol 1e-3 with atol 1e-5 * max|g| (sums in another order),
    and the loss after one AdamW step to rtol 1e-3."""
    loss, grads, after = _step_on(cuda_device, kind)
    ref_loss, ref_grads, ref_after = _step_on(torch.device("cpu"), kind)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=1e-3, atol=1e-5 * scale, err_msg=name)
    np.testing.assert_allclose(after, ref_after, rtol=1e-3)
    assert after < loss
