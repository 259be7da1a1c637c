"""Worker of tests/test_torch_dcn_tp.py: comorag_torch's tensor-parallel
generation over a mesh whose ``model`` axis crosses a process boundary
(``decoder.shard_params`` and ``TorchOfflineLLM(mesh=)`` over a process
mesh).

    python tests/_torch_dcn_tp_worker.py PORT PROCESS_ID OUT_DIR [MODE]

On the CPU (MODE "cpu", the default) two such processes join one gloo
group at 127.0.0.1:PORT and pass half of each mesh's positions on the
CPU (2 of {"model": 4}, 1 of {"model": 2}); they load the
weight trees the test wrote to OUT_DIR/weights.npz (JAX's trees as numpy
arrays), run the ``run_*`` cases, each process in a directory of its own,
and write their results to OUT_DIR/rank<PROCESS_ID>.npz. The test calls
the same ``run_*`` on one process's meshes of the same shapes. On cards
(MODE "nccl N": N processes, one card each, ``run_cards``) they hold
the logits and greedy tokens of a Llama-width model against one
process's mesh over the same cards. This file imports neither jax nor
comorag_tpu, and checks so at its end.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from comorag_torch.llm.offline import ByteTokenizer, TorchOfflineLLM
from comorag_torch.llm.serving import GenerationServer
from comorag_torch.models import curriculum
from comorag_torch.models import decoder
from comorag_torch.ops import int4 as int4_ops
from comorag_torch.parallel import distributed
from comorag_torch.parallel.mesh import Sharded, build_mesh
from comorag_torch.utils import trace

CPU = torch.device("cpu")
SHAPES = {"model4": {"model": 4}, "model2": {"model": 2}}
# (a): tests/test_torch_tp.py's shard-rule arch (qk-norm, qkv bias) at the
# vocabulary of a split int4 head (256) and of a whole one (259)
A_ARCH = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128, max_seq_len=256,
              qk_norm=True, head_dim_override=32, qkv_bias=True)
A_VOCABS = (256, 259)
# (b): the fused tail's gate shape (hidden 512, intermediate 1024): one
# process's {"model": 4} and {"model": 2} take the fused tail at decode
B_ARCH = dict(vocab_size=256, hidden_size=512, num_layers=2, num_heads=8, num_kv_heads=2, intermediate_size=1024,
              max_seq_len=256)
KINDS = ("float", "int8", "int4")
B_RUNS = (("float", None), ("int8", None), ("int8", "int8"), ("int4", None))  # (weights, KV cache)
PROMPT_ROWS, PROMPT_LEN = 2, 40  # 80 prompt tokens: an int4 prefill size (above 64)
GEN_TOKENS = 16
SERVER_MESSAGES = ["Who kept the lantern on the hill?", "Name the three bells of the harbor.",
                   "Where did Fiora catalogue the iron key?"]
SERVER_TOKENS = 8
F_CHUNKS = 24
F_QUESTION = "Who hid the moonstone crown in the cistern?"
F_NEW_TOKENS = 8


# ------------------------------------------------------------ the weights
def flatten(tree, prefix: str = "") -> dict:
    """A parameter tree (dicts, and quantized leaves with ``_fields``) as
    {path: array}; JAX's trees and the port's flatten alike."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in flatten(sub, f"{prefix}{name}/").items()}
    fields = getattr(tree, "_fields", None)
    if fields:
        return {f"{prefix}{f}": np.asarray(getattr(tree, f)) for f in fields}
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat: dict) -> dict:
    """``flatten``'s inverse, with the port's ``QuantWeight`` and
    ``Int4Weight`` for the quantized leaves."""
    tree: dict = {}
    for path, value in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value

    def build(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"packed", "scale"}:
            return decoder.Int4Weight(node["packed"], node["scale"])
        if set(node) == {"q", "scale"}:
            return decoder.QuantWeight(node["q"], node["scale"])
        return {k: build(v) for k, v in node.items()}

    return build(tree)


def load_trees(path: str) -> dict:
    """The test's weights.npz as {tree name: numpy tree} (keys
    "<name>|<path>")."""
    trees: dict = {}
    with np.load(path) as f:
        for key in f.files:
            name, leaf = key.split("|")
            trees.setdefault(name, {})[leaf] = f[key]
    return {name: unflatten(flat) for name, flat in trees.items()}


def b_arch() -> decoder.DecoderArch:
    return decoder.DecoderArch(**B_ARCH)


# ------------------------------------------------------------ (a) the split
def _blocks(tree, prefix: str) -> dict:
    """Every ``Sharded`` leaf's blocks as {"<path>@<axis index>": array}."""
    out = {}
    if isinstance(tree, dict):
        for name, sub in tree.items():
            out.update(_blocks(sub, f"{prefix}/{name}"))
    elif isinstance(tree, Sharded):
        for i, shard in enumerate(tree.shards):
            for path, value in flatten(shard, f"{prefix}/").items():
                out[f"{path}@{tree.position(i)}"] = value
    elif isinstance(tree, tuple):
        for f, t in zip(tree._fields, tree):
            out.update(_blocks(t, f"{prefix}/{f}"))
    return out


def run_split(mesh_of, trees) -> dict:
    """(a): ``shard_params`` of every kind at both vocabularies over
    ``SHAPES``: the blocks this process holds (keyed by their axis index),
    and whether ``unshard_params`` (which gathers the other processes'
    blocks) gives the whole tree back bit for bit."""
    out = {}
    for shape_name, shape in SHAPES.items():
        mesh = mesh_of(shape)
        for kind in KINDS:
            for vocab in A_VOCABS:
                params = decoder.params_from_jax(trees[f"a/{kind}/{vocab}"], device="cpu")
                sharded = decoder.shard_params(params, mesh)
                key = f"a/{shape_name}/{kind}/{vocab}"
                out.update(_blocks(sharded, key))
                whole = flatten(decoder.unshard_params(sharded, "cpu"))
                want = flatten(params)
                out[f"{key}/unsharded_equal"] = np.asarray(
                    whole.keys() == want.keys() and all(np.array_equal(whole[k], want[k]) for k in want))
    return out


# ----------------------------------------------------------- (b) the forward
def prompt_batch(seed: int = 2, rows: int = PROMPT_ROWS, length: int = PROMPT_LEN, vocab: int = 256):
    """tests/test_torch_tp.py's left-padded batch: row 1 pads its first
    third."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(rows, length)).astype(np.int64)
    mask = np.ones((rows, length), np.int64)
    mask[1, : length // 3] = 0
    ids[mask == 0] = 0
    return ids, mask


class CountedInt4:
    """Counts ``int4_matmul`` and fused-tail calls (the CPU runs their
    plain versions, which no launch counter sees)."""

    def __init__(self):
        self.matmul = self.tail = 0
        self._fns = int4_ops.int4_matmul, int4_ops.int4_fused_layer_tail

    def __enter__(self):
        matmul, tail = self._fns

        def counted_matmul(*a, **kw):
            self.matmul += 1
            return matmul(*a, **kw)

        def counted_tail(*a, **kw):
            self.tail += 1
            return tail(*a, **kw)

        int4_ops.int4_matmul, int4_ops.int4_fused_layer_tail = counted_matmul, counted_tail
        return self

    def __exit__(self, *exc):
        int4_ops.int4_matmul, int4_ops.int4_fused_layer_tail = self._fns


def prefill_and_step(params, arch, ids, mask, kv_dtype=None, tok=None):
    """One prefill chunk of the batch and one decode step on a KV cache of
    P + 1 slots, fed ``tok`` (else the greedy token): (prompt logits [B,
    P, V], step logits [B, V], the token, the cache's keys, and each
    forward's (m, head rows, int4_matmul calls, fused-tail calls))."""
    b, p = ids.shape
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    positions = torch.clamp(torch.cumsum(mask, 1) - 1, min=0)
    attn = torch.zeros(b, p, p + 1, dtype=torch.bool)
    attn[:, :, :p] = torch.tril(torch.ones(p, p, dtype=torch.bool))[None] & mask.bool()[:, None, :]
    cache = decoder.make_kv_cache(arch, b, p + 1, torch.float32, kv_dtype, device="cpu")
    calls = []
    with torch.no_grad(), CountedInt4() as c:
        logits, cache = decoder.decoder_forward(params, ids, positions, attn, cache, 0, arch)
        calls.append((b * p, b * p, c.matmul, c.tail))
        tok = logits[:, -1].argmax(-1) if tok is None else torch.as_tensor(tok)
        valid = torch.cat([mask.bool(), torch.ones(b, 1, dtype=torch.bool)], dim=1)
        step, cache = decoder.decoder_forward(params, tok[:, None], mask.sum(1)[:, None], valid[:, None, :], cache,
                                              p, arch)
        calls.append((b, b, c.matmul - calls[0][2], c.tail - calls[0][3]))
    k = cache.k if isinstance(cache, decoder.KVCache) else cache.k.to(torch.float32) * cache.k_scale[..., None]
    return logits.numpy(), step[:, 0].numpy(), tok.numpy(), k.numpy(), calls


def run_forward(mesh_of, trees) -> dict:
    """(b) and (e): one prefill chunk and one decode step of
    ``decoder_forward`` over ``SHAPES`` for every kind (int8 also with the
    int8 KV cache); int4's calls of each forward beside
    ``decoder.int4_forward_launches``, the route of its decode step and
    of qkv at both sizes."""
    arch = b_arch()
    ids, mask = prompt_batch()
    out = {}
    for shape_name, shape in SHAPES.items():
        mesh = mesh_of(shape)
        for kind, kv in B_RUNS:
            params = decoder.shard_params(decoder.params_from_jax(trees[f"b/{kind}"], device="cpu"), mesh)
            key = f"b/{shape_name}/{kind}/{kv or 'float'}_kv"
            out[f"{key}/prompt"], out[f"{key}/step"], out[f"{key}/tok"], out[f"{key}/k"], calls = prefill_and_step(
                params, arch, ids, mask, kv)
            if kind == "int4":
                out[f"{key}/calls"] = np.asarray([c[2:] for c in calls])
                out[f"{key}/want_calls"] = np.asarray([decoder.int4_forward_launches(params, arch, m, head_m)
                                                       for m, head_m, _, _ in calls])
                out[f"{key}/routes"] = np.asarray(
                    [decoder.tail_route(params, arch, m) for m, *_ in calls]
                    + [decoder.product_route(params["layers"]["qkv_w"], m, mesh.device) for m, *_ in calls])
    return out


# ---------------------------------------------------- (c) the tiny engine
def tiny():
    params, arch = curriculum.load_tiny_checkpoint(curriculum.default_checkpoint_path())
    return decoder.params_from_jax(params, device="cpu"), arch


def tiny_prompts(n_rows: int = 2, task: str = "ner", seed: int = 0):
    """test_generate_under_tp_matches_jax_on_the_trained_checkpoint's
    prompts: the curriculum's samples, BOS first, left-padded."""
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    texts = [curriculum.make_sample(rng, task)["prompt"] for _ in range(n_rows)]
    rows = [[tok.bos_token_id] + tok.encode(t) for t in texts]
    p = max(len(r) for r in rows)
    ids = np.full((len(rows), p), tok.pad_token_id, np.int64)
    mask = np.zeros((len(rows), p), np.int64)
    for i, r in enumerate(rows):
        ids[i, p - len(r):], mask[i, p - len(r):] = r, 1
    return ids, mask, texts


def run_generate(mesh_of) -> dict:
    """(c): ``TorchOfflineLLM(mesh=)`` over {"model": 4} on the trained
    tiny checkpoint: greedy ``generate`` on the engine's split weights,
    fp32 and int4, and the texts of one ``batch_infer`` of an engine with
    ``speculative=True``."""
    params, arch = tiny()
    mesh = mesh_of(SHAPES["model4"])
    ids, mask, texts = tiny_prompts()
    tok = ByteTokenizer()
    out = {}
    for name, param_dtype in (("fp32", None), ("int4", "int4")):
        engine = TorchOfflineLLM(params=params, arch=arch, mesh=mesh, param_dtype=param_dtype,
                                 max_new_tokens=GEN_TOKENS)
        with torch.no_grad():
            r = decoder.generate(engine.params, torch.as_tensor(ids), torch.as_tensor(mask), arch,
                                 max_new_tokens=GEN_TOKENS, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id)
        out[f"c/{name}/tokens"], out[f"c/{name}/lengths"] = r.tokens.numpy(), r.lengths.numpy()
        out[f"c/{name}/steps"] = np.int64(r.steps)
        out[f"c/{name}/across"] = np.asarray(engine.across_processes)
    spec = TorchOfflineLLM(params=params, arch=arch, mesh=mesh, speculative=True, max_new_tokens=GEN_TOKENS)
    messages = [[{"role": "user", "content": t}] for t in texts]
    out["c/spec_texts"] = np.asarray([r.text for r in spec.batch_infer(messages, max_tokens=GEN_TOKENS)])
    return out


# ----------------------------------------------------------- (d) the server
def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads what was raised
        return f"{type(e).__name__}: {e}"
    return ""


def run_server(mesh_of) -> dict:
    """(d): ``GenerationServer`` over the tiny engine split over {"model":
    4}: one ``batch_infer`` of 3 requests and one ``infer``, each one
    engine call (``llm.*`` counters, ``batched_with``); over a process
    mesh also a call whose prompt differs in process 1, one more call
    after it, and a call from another thread than the server's."""
    params, arch = tiny()
    engine = TorchOfflineLLM(params=params, arch=arch, mesh=mesh_of(SHAPES["model4"]), max_new_tokens=32)
    server = GenerationServer(engine)
    messages = [[{"role": "user", "content": m}] for m in SERVER_MESSAGES]
    out = {"d/in_order": np.asarray(server.in_order)}
    try:
        trace.reset()
        batch = server.batch_infer(messages, max_tokens=SERVER_TOKENS)
        one = server.infer(messages[0], max_tokens=SERVER_TOKENS)
        counters = trace.summary()["counters"]
        out["d/texts"] = np.asarray([r.text for r in batch + [one]])
        out["d/batched_with"] = np.asarray([r.metadata["batched_with"] for r in batch + [one]])
        out["d/engine_calls"] = np.asarray([counters.get("llm.calls", 0), counters.get("llm.rows", 0)])
        if server.in_order:
            pid = distributed.process_index()
            differs = [{"role": "user", "content": f"{SERVER_MESSAGES[1]} (asked by process {pid})"}]
            out["d/differs"] = np.asarray(_raised(lambda: server.infer(differs, max_tokens=SERVER_TOKENS)))
            out["d/after"] = np.asarray(server.infer(messages[2], max_tokens=SERVER_TOKENS).text)
            with ThreadPoolExecutor(1) as pool:  # a caller in another thread than the one that built the server
                out["d/other_thread"] = np.asarray(pool.submit(
                    _raised, lambda: server.infer(messages[0], max_tokens=SERVER_TOKENS)).result())
    finally:
        server.close()
    return out


# --------------------------------------------------------- (f) the meta loop
def f_corpus() -> list:
    names = ["Arden", "Brisa", "Corin", "Davet", "Elwyn", "Fiora"]
    places = ["mill", "harbor", "orchard", "quarry", "archive", "forge"]
    chunks = [f"Record {i} - {names[i % 6]} visited the {places[(i * 5) % 6]} on day {3 * i + 1}."
              for i in range(F_CHUNKS)]
    chunks[7] = "Record 7 - Quintessa hid the moonstone crown inside the old cistern beneath the granary."
    return chunks


def run_comorag(mesh_of, workdir: str) -> dict:
    """(f): ``ComoRAG(mesh=)`` with ``llm_name="jax-tiny"`` over {"model":
    2, "corpus": 2} (the model axis across the processes, the corpus
    shards both in process 0): the stores indexed with FakeLLM's OpenIE,
    then one question answered in lockstep through ``get_llm``'s engine
    over the mesh; and over {"corpus": 2, "model": 2}, where each process
    owns the whole model axis, whether ``get_llm``'s engine merges across
    processes (it runs a replica) and the blocks it holds."""
    from comorag_torch.comorag import ComoRAG
    from comorag_torch.config import ComoConfig
    from comorag_torch.llm import get_llm
    from comorag_torch.llm.fake import FakeLLM

    config = ComoConfig(llm_name="jax-tiny", embedding_model_name="hash", embedding_dim=64, need_cluster=False,
                        skip_graph=True, max_meta_loop_iterations=1, save_dir=os.path.join(workdir, "outputs"),
                        output_dir=os.path.join(workdir, "results"))
    mesh = mesh_of({"model": 2, "corpus": 2})
    rag = ComoRAG(config, llm=FakeLLM(), mesh=mesh)
    rag.index(f_corpus())
    rag.llm = get_llm(config, mesh=mesh)
    rag.llm.engine.max_new_tokens = F_NEW_TOKENS  # short answers keep the case inside the module's time
    try:
        out = {"f/answer": np.asarray(rag.try_answer([F_QUESTION])[0].answer),
               "f/across": np.asarray(rag.llm.engine.across_processes)}
    finally:
        rag.llm.close()
    replica = get_llm(config, mesh=mesh_of({"corpus": 2, "model": 2}))
    qkv = replica.engine.params["layers"]["qkv_w"]
    out["f/replica_across"] = np.asarray(replica.engine.across_processes)
    out["f/replica_blocks"] = np.asarray([qkv.position(i) for i in range(len(qkv.shards))])
    replica.close()
    return out


def run_cpu(workdir: str, trees) -> dict:
    """Every CPU case in this process, in the order the two processes run
    them (the mesh builds and merges meet over the group)."""
    def mesh_of(shape):  # this process's half of the positions
        return build_mesh(shape, [CPU] * (int(np.prod(list(shape.values()))) // 2))

    out = {}
    for name, case in (("a", lambda: run_split(mesh_of, trees)), ("b", lambda: run_forward(mesh_of, trees)),
                       ("c", lambda: run_generate(mesh_of)), ("d", lambda: run_server(mesh_of)),
                       ("f", lambda: run_comorag(mesh_of, workdir))):
        t0 = time.perf_counter()
        out.update(case())
        print(f"case ({name}): {time.perf_counter() - t0:.1f} s", flush=True)
    out["local_model"] = np.asarray(mesh_of(SHAPES["model4"]).local_indices("model"))
    return out


# ---------------------------------------------------------------- the cards
def llama_width(layers: int = 2) -> decoder.DecoderArch:
    """Llama-3.1-8B's published widths at ``layers`` layers."""
    return decoder.DecoderArch(vocab_size=128256, hidden_size=4096, num_layers=layers, num_heads=32, num_kv_heads=8,
                               intermediate_size=14336, max_seq_len=131072, rope_theta=500000.0, rms_norm_eps=1e-5,
                               rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0))


def run_cards(devices) -> dict:
    """A {"model": n} mesh over ``devices`` (each process's one card, or
    one process's n cards), Llama-3.1-8B width at 2 layers, weights drawn
    from seed 0 on the CPU (the same in every process), int4 then bf16:
    the fp32-compute last-prompt and decode-step logits and 16 greedy
    tokens of 4 prompts of 96 tokens."""
    arch = llama_width()
    params = decoder.init_params(arch, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    mesh = build_mesh({"model": len(devices) * distributed.process_count()}, devices)
    ids = torch.randint(0, 256, (4, 96), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    out = {}
    for name, param_dtype in (("int4", "int4"), ("bf16", torch.bfloat16)):
        engine = TorchOfflineLLM(params=params, arch=arch, param_dtype=param_dtype, mesh=mesh)
        dev = engine.device
        with torch.no_grad():
            last, cache, slot_valid, row_len = decoder._prefill_batch(
                engine.params, ids.to(dev), mask.to(dev), arch, ids.shape[1] + 1, None, torch.float32)
            slot_valid[:, ids.shape[1]] = True
            step, _ = decoder.decoder_forward(engine.params, last.argmax(-1)[:, None], row_len[:, None],
                                              slot_valid[:, None, :], cache, ids.shape[1], arch, torch.float32)
            tokens = decoder.generate(engine.params, ids.to(dev), mask.to(dev), arch, 16, eos_id=-1, pad_id=0,
                                      compute_dtype=torch.bfloat16).tokens
        out[f"{name}/logits"] = torch.cat([last, step[:, 0]]).float().cpu().numpy()
        out[f"{name}/tokens"] = tokens.cpu().numpy()
        del engine
    return out


def main(argv) -> None:
    """argv: PORT PROCESS_ID OUT_DIR [MODE]; MODE "cpu" (the default) or
    "nccl N" (N processes, process i on cuda:i, ``run_cards``)."""
    port, pid, out_dir = argv[1], int(argv[2]), argv[3]
    mode = argv[4] if len(argv) > 4 else "cpu"
    torch.set_num_threads(2)
    address = f"127.0.0.1:{port}"
    if mode == "cpu":
        distributed.initialize(address, 2, pid, device="cpu", timeout_s=60)
    else:
        n = int(mode.split()[1])
        distributed.initialize(address, n, pid, backend="nccl", device=torch.device("cuda", pid), timeout_s=120)
    try:
        if mode == "cpu":
            results = run_cpu(os.path.join(out_dir, f"work{pid}"), load_trees(os.path.join(out_dir, "weights.npz")))
        else:
            results = run_cards([torch.device("cuda", pid)])
        results["backend"] = np.asarray(distributed.backend())
        np.savez(os.path.join(out_dir, f"rank{pid}.npz"), **results)
    finally:
        distributed.shutdown()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "comorag_tpu", "__graft_entry__"))
    if loaded:
        raise SystemExit(f"the worker loaded {loaded[:5]}")
    print(f"TORCH_DCN_TP_OK {pid}", flush=True)


if __name__ == "__main__":
    main(sys.argv)
