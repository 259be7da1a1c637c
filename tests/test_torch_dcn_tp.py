"""comorag_torch's tensor-parallel generation over a mesh whose ``model``
axis crosses a process boundary: ``decoder.shard_params`` and
``TorchOfflineLLM(mesh=)`` over a process mesh, each process holding its
own blocks and merging the products with the other's
(``parallel/distributed.py``).

Two processes of tests/_torch_dcn_tp_worker.py join one gloo group on
127.0.0.1, each passing half of every mesh's CPU positions (2 of
{"model": 4}) and working in a directory of its own; the
job runs once per module, while this process computes the references.
The weights are JAX's (``init_params`` with perturbed norms, then its
int8 / int4 quantization), written as numpy arrays and carried across
with ``decoder.params_from_jax``. Every result is held three ways:

  - equal in both processes, bit for bit;
  - equal to one process's mesh of the same shape on ``[CPU] * n``: bit
    for bit wherever both take the same route (float and int8 weights,
    the int8 KV cache, int4 at a prefill size); int4 at decode, where one
    process takes the fused tail's plain version and the process mesh
    the per-product route, within tests/test_torch_tp.py's int4 rule
    (2e-2 * max|logit| + 2e-2 * |logit|) with the same top-1;
  - against JAX's ``param_shardings`` forward and generation on the
    conftest's virtual CPU devices, with tests/test_torch_tp.py's
    tolerances (fp32 logits of float and int8 weights 1e-4; int4 the rule
    above, top-1 on >= 95 % of the positions; greedy tokens equal).

Cases: (a) the blocks of ``shard_params`` over {"model": 4} and {"model":
2}, float / int8 / int4, vocab 256 (a split int4 head) and 259 (a whole
one), and ``unshard_params`` gathering them back; (b) one prefill chunk
and one decode step of ``decoder_forward``; (c) greedy generation of
``TorchOfflineLLM(mesh=)`` and one speculative engine call on the trained tiny checkpoint
(assets/tiny_lm.npz), fp32 and int4; (d) ``GenerationServer`` over the
process mesh: one engine call a call, a prompt that differs in one
process raising in both, a call from another thread refused; (e) int4_matmul calls
a forward in each process against ``decoder.int4_forward_launches``; (f)
one ``ComoRAG(mesh=)`` question with ``llm_name="jax-tiny"`` over
{"model": 2, "corpus": 2} (the model axis across the processes; over
{"corpus": 2, "model": 2} each process owns the whole model axis, and
its engine is a replica that merges nothing across them). The
CUDA-marked test runs one NCCL process a card; JAX is imported where
the references need it, so that the file loads on a card's machine
without JAX (``--noconftest``).
"""

import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from comorag_torch.parallel.mesh import build_mesh

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


worker = _load("_torch_dcn_tp_worker")
CPU = torch.device("cpu")
TIMEOUT_S = 420  # a hang guard: the module takes ~40 s alone, a few minutes beside five busy test workers
INT4_RTOL = 2e-2  # tests/test_torch_tp.py's int4 rule, scaled to max |logit|
FLOAT_TOL = 1e-4  # tests/test_torch_tp.py's fp32 tolerance (sums in another order)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_params(jarch, seed, kind):
    """tests/test_torch_tp.py's weights: JAX's init_params with the norms
    perturbed (ones would hide a misplaced norm), then quantized."""
    import jax
    from comorag_tpu.models import decoder as jdec

    params = jdec.init_params(jax.random.PRNGKey(seed), jarch)
    rng = np.random.default_rng(seed)
    for name in ("attn_norm", "ffn_norm", "q_norm", "k_norm"):
        if name in params["layers"]:
            w = params["layers"][name]
            params["layers"][name] = w + 0.1 * rng.standard_normal(w.shape).astype(np.float32)
    if kind == "int8":
        return jdec.quantize_params(params)
    if kind == "int4":
        return jdec.quantize_params_int4(params)
    return params


def _jax_trees() -> dict:
    """JAX's trees of (a) and (b) as numpy trees."""
    import jax
    from comorag_tpu.models import decoder as jdec

    trees = {}
    for kind in worker.KINDS:
        for vocab in worker.A_VOCABS:
            trees[f"a/{kind}/{vocab}"] = _jax_params(jdec.DecoderArch(vocab_size=vocab, **worker.A_ARCH), 0, kind)
        trees[f"b/{kind}"] = _jax_params(jdec.DecoderArch(**worker.B_ARCH), 5, kind)
    return {name: jax.tree_util.tree_map(np.asarray, t) for name, t in trees.items()}


def _start(out) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE)] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dcn_tp_worker.py"), str(port), str(pid),
                              str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for pid in (0, 1)]


def _one_process(tmp, trees) -> dict:
    """The worker's cases on one process's meshes of the same shapes."""
    def mesh_of(shape):
        return build_mesh(shape, [CPU] * int(np.prod(list(shape.values()))))

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = worker.run_split(mesh_of, trees)
        out.update(worker.run_forward(mesh_of, trees))
        out.update(worker.run_generate(mesh_of))
        out.update(worker.run_server(mesh_of))
        out.update(worker.run_comorag(mesh_of, str(tmp)))
    finally:
        torch.set_num_threads(n)
    return out


def _jax_prefill_and_step(jarch, jparams, ids, mask, tok):
    """JAX's prefill chunk and decode step, as the worker's
    ``prefill_and_step`` runs them, the step fed ``tok``."""
    import jax.numpy as jnp
    from comorag_tpu.models import decoder as jdec

    b, p = ids.shape
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    attn = np.zeros((b, p, p + 1), bool)
    attn[:, :, :p] = np.tril(np.ones((p, p), bool))[None] & mask.astype(bool)[:, None, :]
    cache = jdec.make_kv_cache(jarch, b, p + 1, jnp.float32, None)
    logits, cache = jdec.decoder_forward(jparams, jnp.asarray(ids, jnp.int32), jnp.asarray(positions),
                                         jnp.asarray(attn), cache, jnp.int32(0), jarch)
    valid = np.concatenate([mask.astype(bool), np.ones((b, 1), bool)], axis=1)
    step, _ = jdec.decoder_forward(jparams, jnp.asarray(tok[:, None], jnp.int32),
                                   jnp.asarray(mask.sum(1)[:, None], jnp.int32), jnp.asarray(valid[:, None, :]),
                                   cache, jnp.int32(p), jarch)
    return np.asarray(logits), np.asarray(step)[:, 0]


def _jax(trees, single) -> dict:
    """JAX's forward of (b) over {"model": 4} on 4 virtual CPU devices (the
    step fed the port's token), and its greedy generation of (c) over the
    same mesh on the trained tiny checkpoint."""
    import jax
    import jax.numpy as jnp
    from comorag_tpu.models import curriculum as jcur
    from comorag_tpu.models import decoder as jdec
    from comorag_tpu.parallel.mesh import build_mesh as jax_build_mesh

    jmesh = jax_build_mesh({"model": 4}, devices=jax.devices()[:4])
    jarch = jdec.DecoderArch(**worker.B_ARCH)
    ids, mask = worker.prompt_batch()
    out = {}
    for kind in worker.KINDS:
        quantized = {"float": False, "int8": True, "int4": "int4"}[kind]
        shardings = jdec.param_shardings(jmesh, arch=jarch, quantized=quantized)
        params = jax.tree_util.tree_map(lambda p, s: jax.device_put(p, s), trees[f"b/{kind}"], shardings)
        tok = single[f"b/model4/{kind}/float_kv/tok"]
        out[f"b/{kind}/prompt"], out[f"b/{kind}/step"] = _jax_prefill_and_step(jarch, params, ids, mask, tok)
    jparams, tarch = jcur.load_tiny_checkpoint(jcur.default_checkpoint_path())
    shardings = jdec.param_shardings(jmesh, arch=tarch, quantized=False)
    jparams = jax.tree_util.tree_map(lambda p, s: jax.device_put(jnp.asarray(p), s), jparams, shardings)
    ids, mask, _ = worker.tiny_prompts()
    gen = jax.jit(jdec.generate, static_argnames=("arch", "max_new_tokens", "eos_id", "pad_id"))
    tok = worker.ByteTokenizer()
    r = gen(jparams, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32), arch=tarch,
            max_new_tokens=worker.GEN_TOKENS, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id)
    out["c/tokens"], out["c/lengths"], out["c/steps"] = np.asarray(r.tokens), np.asarray(r.lengths), int(r.steps)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(both processes' results, one process's, JAX's): the two-process job
    runs while this process computes the references."""
    out = tmp_path_factory.mktemp("torch_dcn_tp")
    trees = _jax_trees()
    np.savez(out / "weights.npz", **{f"{name}|{path}": v for name, tree in trees.items()
                                     for path, v in worker.flatten(tree).items()})
    procs = _start(out)
    try:
        single = _one_process(tmp_path_factory.mktemp("one_process"), worker.load_trees(str(out / "weights.npz")))
        jax_ref = _jax(trees, single)
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the two-process job did not end within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_DCN_TP_OK {pid}" in log, f"process {pid} failed:\n{log[-4000:]}"
    return [dict(np.load(out / f"rank{pid}.npz")) for pid in (0, 1)], single, jax_ref


def _across(runs, key):
    """The key's result, equal in both processes bit for bit."""
    ranks = runs[0]
    np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=f"{key}: the processes disagree")
    return ranks[0][key]


def _same(runs, key):
    """The key's result: equal in both processes and to one process's mesh,
    bit for bit."""
    got = _across(runs, key)
    np.testing.assert_array_equal(got, runs[1][key], err_msg=f"{key}: differs from one process's mesh")
    return got


def _int4_rule(got, ref, top1=1.0):
    np.testing.assert_allclose(got, ref, rtol=INT4_RTOL, atol=INT4_RTOL * np.abs(ref).max())
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= top1


# ------------------------------------------------------------- (a) the split
@pytest.mark.parametrize("shape", sorted(worker.SHAPES))
def test_each_process_holds_its_own_blocks(runs, shape):
    """Over {"model": 4} process p holds blocks 2p and 2p + 1, over
    {"model": 2} block p, of every split leaf of every kind and vocabulary,
    each equal to the block one process's mesh puts at that index; the
    processes' blocks together are one process's, and unshard_params
    (every process gathering the others' blocks) gives every whole tree
    back bit for bit."""
    ranks, single, _ = runs
    prefix = f"a/{shape}/"
    want = {k: v for k, v in single.items() if k.startswith(prefix) and "@" in k}
    held = [{k: v for k, v in r.items() if k.startswith(prefix) and "@" in k} for r in ranks]
    per = 2 if shape == "model4" else 1
    for pid, blocks in enumerate(held):
        assert blocks and {int(k.rsplit("@", 1)[1]) for k in blocks} == set(range(pid * per, (pid + 1) * per))
        for k, v in blocks.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert set(held[0]) | set(held[1]) == set(want) and not set(held[0]) & set(held[1])
    for kind in worker.KINDS:
        for vocab in worker.A_VOCABS:
            assert bool(_same(runs, f"{prefix}{kind}/{vocab}/unsharded_equal"))
    # the int4 head splits at vocab 256 and stays whole at 259
    assert any("/256/lm_head/packed@" in k for k in want) and not any("/259/lm_head/" in k for k in want)


def test_local_positions_are_process_major(runs):
    ranks, _, _ = runs
    assert ranks[0]["local_model"].tolist() == [0, 1] and ranks[1]["local_model"].tolist() == [2, 3]


def _fake_mesh(names, processes, me):
    """A mesh of ``processes`` (an int grid over axes ``names``) seen from
    process ``me``: CPU positions where it owns them, RemoteDevice
    elsewhere; no group needed."""
    from comorag_torch.parallel.mesh import Mesh, RemoteDevice

    procs = np.asarray(processes)
    devices = np.empty(procs.size, dtype=object)
    devices[:] = [CPU if p == me else RemoteDevice(int(p), "cpu") for p in procs.flat]
    return Mesh(devices.reshape(procs.shape), names, procs, me)


@pytest.mark.parametrize("names,processes,me,want,blocks", [
    (("model",), [0, 0, 1, 1], 0, (0, 1), 2),
    (("model",), [0, 0, 1, 1], 1, (2, 3), 2),
    (("model", "corpus"), [[0, 0], [1, 1]], 1, (1,), 1),
    (("corpus", "model"), [[0, 0], [1, 1]], 1, None, 2),  # every process owns the whole axis: a replica
    (("model",), [0, 0, 0, 0], 0, None, 4),  # one process
])
def test_model_part_gives_each_process_its_blocks(names, processes, me, want, blocks):
    """The axis indices of the blocks a process holds (None: every block)
    and one CPU position for each."""
    from comorag_torch.parallel.mesh import model_part

    assert model_part(_fake_mesh(names, processes, me)) == (want, (CPU,) * blocks)


def test_model_part_refuses_a_block_copied_in_some_processes():
    """{"model": 2, "data": 2} over 3 processes: model index 0 lies in
    processes 0 and 1, index 1 in process 2 alone."""
    from comorag_torch.parallel.mesh import model_part

    with pytest.raises(NotImplementedError, match=r"model indices \[0\] .* not in every one"):
        model_part(_fake_mesh(("model", "data"), [[0, 1], [2, 2]], 0))


# ----------------------------------------------------------- (b) the forward
_B_KEYS = [f"{shape}/{kind}/{kv or 'float'}_kv" for shape in sorted(worker.SHAPES) for kind, kv in worker.B_RUNS]


@pytest.mark.parametrize("key", _B_KEYS)
def test_forward_across_processes(runs, key):
    """The prompt logits, the decode step's logits and the KV cache: bit-
    equal in both processes and to one process's mesh where the routes
    match (every prompt chunk, float and int8 decode, the int8 KV cache);
    int4's decode step within the int4 rule of one process's fused tail,
    with the same top-1; against JAX's param_shardings forward over
    {"model": 4}."""
    ranks, single, jax_ref = runs
    shape, kind, _ = key.split("/")
    prompt, tok = _same(runs, f"b/{key}/prompt"), _same(runs, f"b/{key}/tok")
    k = _across(runs, f"b/{key}/k")
    step = _across(runs, f"b/{key}/step")
    if kind == "int4":
        np.testing.assert_array_equal(k[:, :, : worker.PROMPT_LEN], single[f"b/{key}/k"][:, :, : worker.PROMPT_LEN])
        _int4_rule(step, single[f"b/{key}/step"])
    else:
        np.testing.assert_array_equal(k, single[f"b/{key}/k"])
        np.testing.assert_array_equal(step, single[f"b/{key}/step"])
    if shape == "model4" and key.endswith("float_kv"):
        np.testing.assert_array_equal(tok, single[f"b/model4/{kind}/float_kv/tok"])
        if kind == "int4":
            _int4_rule(prompt, jax_ref[f"b/{kind}/prompt"], 0.95)
            _int4_rule(step, jax_ref[f"b/{kind}/step"], 0.95)
        else:
            np.testing.assert_allclose(prompt, jax_ref[f"b/{kind}/prompt"], rtol=FLOAT_TOL, atol=FLOAT_TOL)
            np.testing.assert_allclose(step, jax_ref[f"b/{kind}/step"], rtol=FLOAT_TOL, atol=FLOAT_TOL)


# ---------------------------------------------------- (e) the int4 launches
@pytest.mark.parametrize("shape", sorted(worker.SHAPES))
def test_int4_calls_a_forward_follow_int4_forward_launches(runs, shape):
    """Each process's int4_matmul and fused-tail calls of the prompt chunk
    and of the decode step equal ``decoder.int4_forward_launches`` on its
    own split weights: no fused tail across processes (the per-product
    route), where one process's mesh takes it at decode."""
    ranks, single, _ = runs
    key = f"b/{shape}/int4/float_kv"
    for r in ranks:
        np.testing.assert_array_equal(r[f"{key}/calls"], r[f"{key}/want_calls"])
        assert r[f"{key}/calls"][:, 1].tolist() == [0, 0]
        assert r[f"{key}/routes"][:2].tolist() == ["per_product", "per_product"]
    np.testing.assert_array_equal(single[f"{key}/calls"], single[f"{key}/want_calls"])
    assert single[f"{key}/routes"][:2].tolist() == ["per_product", "fused_tail"]
    if shape == "model4":  # at prefill each process's two 192-column qkv blocks are one wgmma call, as the mesh's 4
        assert ranks[0][f"{key}/calls"][0, 0] == single[f"{key}/calls"][0, 0]


# ------------------------------------------------------ (c) the tiny engine
@pytest.mark.parametrize("name", ["fp32", "int4"])
def test_engine_generates_alike_across_processes(runs, name):
    """TorchOfflineLLM(mesh=) over {"model": 4} across the processes on the
    trained tiny checkpoint: greedy tokens, lengths and steps equal in both
    processes, to one process's mesh and (fp32) to JAX's over the same
    mesh; the speculative engine's texts equal one process's."""
    ranks, single, jax_ref = runs
    tokens, lengths = _same(runs, f"c/{name}/tokens"), _same(runs, f"c/{name}/lengths")
    steps = _same(runs, f"c/{name}/steps")
    assert [bool(r[f"c/{name}/across"]) for r in ranks] == [True, True] and not bool(single[f"c/{name}/across"])
    if name == "fp32":
        np.testing.assert_array_equal(tokens, jax_ref["c/tokens"])
        np.testing.assert_array_equal(lengths, jax_ref["c/lengths"])
        assert int(steps) == jax_ref["c/steps"]
        assert all(_same(runs, "c/spec_texts"))


# ----------------------------------------------------------- (d) the server
def test_server_serves_each_call_alone_in_order(runs):
    """Over the process mesh GenerationServer serves each call as one engine
    call (a batch_infer of 3 rows, then an infer of 1), with the texts of
    one process's windowed server; a prompt that differs in process 1
    raises in both, the next call answers in both, and a call from
    another thread than the server's is refused in both."""
    ranks, single, _ = runs
    assert all(bool(r["d/in_order"]) for r in ranks) and not bool(single["d/in_order"])
    texts = _same(runs, "d/texts")
    assert len(texts) == 4 and all(texts)
    calls, rows = _across(runs, "d/engine_calls").tolist()  # the batch's prompt buckets, then the infer
    assert rows == 4 and 2 <= calls <= 3
    assert _across(runs, "d/batched_with").tolist() == [2, 2, 2, 0]
    for r in ranks:
        msg = str(r["d/differs"])
        assert msg.startswith("RuntimeError: a batch over a model axis across processes: process(es) [1] disagree "
                              "with process 0"), msg
        assert str(r["d/other_thread"]).startswith("RuntimeError: GenerationServer over a model axis that spans "
                                                   "processes serves only the thread that built it"), r["d/other_thread"]
    assert str(_across(runs, "d/after"))


# ------------------------------------------------------------ (f) the meta loop
def test_comorag_question_with_the_split_engine(runs):
    """One question through ComoRAG(mesh=) over {"model": 2, "corpus": 2}
    with get_llm's jax-tiny engine split across the processes, in
    lockstep: the same answer in both processes and on one process's mesh
    (its threaded try_answer and windowed server). Over {"corpus": 2,
    "model": 2} each process owns the whole model axis: its engine holds
    both blocks and merges nothing across the processes (a replica)."""
    ranks, single, _ = runs
    assert str(_same(runs, "f/answer"))
    assert [bool(r["f/across"]) for r in ranks] == [True, True] and not bool(single["f/across"])
    for r in ranks:
        assert not bool(r["f/replica_across"]) and r["f/replica_blocks"].tolist() == [0, 1]


# ------------------------------------------------------------------ the cards
@pytest.mark.cuda
def test_model_axis_over_nccl_processes_matches_one_process(tmp_path):
    """One NCCL process a card over {"model": n} (every card), Llama-3.1-8B
    width at 2 layers, int4 then bf16 weights: the fp32-compute last-prompt
    and decode-step logits and 16 greedy tokens bit-equal to one process's
    mesh over the same cards (the same shard on the same card, the same
    routes: the per-shard products and the per-product layer tail)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards (one NCCL rank a card)")
    n = torch.cuda.device_count()
    ref = worker.run_cards([torch.device("cuda", i) for i in range(n)])
    torch.cuda.empty_cache()
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE)] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dcn_tp_worker.py"), str(port), str(pid),
                               str(tmp_path), f"nccl {n}"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for pid in range(n)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_DCN_TP_OK {pid}" in log, f"process {pid} failed:\n{log[-4000:]}"
    for pid in range(n):
        got = dict(np.load(tmp_path / f"rank{pid}.npz"))
        assert str(got["backend"]) == "nccl"
        for key, value in ref.items():
            np.testing.assert_array_equal(got[key], value, err_msg=f"process {pid} {key}")
