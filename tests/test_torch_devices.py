"""The port's public constructors, loaders and device-running functions
run on the card unless the caller asks for the CPU: without a card, a call
that names no device raises and says how to ask for the CPU, and
``device="cpu"`` builds (or computes on the CPU)."""

import socket
import types

import numpy as np
import pytest
import torch

from comorag_torch.cluster.raptor import SemanticTree, two_level_soft_cluster
from comorag_torch.config import ComoConfig
from comorag_torch.graph.builder import GraphBuilder
from comorag_torch.models import bge, decoder, train, train_lm
from comorag_torch.ops.gmm import fit_gmm_bic
from comorag_torch.ops.ppr import PPRGraph
from comorag_torch.retrieval.engine import RetrievalEngine
from comorag_torch.retrieval.index import MipsIndex
from comorag_torch.store.embedding_store import EmbeddingStore


def _mips_index(tmp_path, **kw):
    return MipsIndex(np.eye(4, 8, dtype=np.float32), **kw)


def _retrieval_engine(tmp_path, **kw):
    store = EmbeddingStore(None, str(tmp_path / "chunks"), batch_size=8, namespace="chunk")
    return RetrievalEngine(ComoConfig(), encoder=None, ver_store=store, **kw)


def _ppr_graph(tmp_path, **kw):
    src, dst = np.array([0, 1, 2], np.int64), np.array([1, 2, 0], np.int64)
    return PPRGraph(src, dst, np.ones(3, np.float32), 3, backend="device", **kw)


def _semantic_tree(tmp_path, **kw):
    return SemanticTree(encoder=None, summarizer=None, **kw)


def _bge_encoder(tmp_path, **kw):
    params = bge.init_params(bge.EncoderArch.tiny(), torch.Generator().manual_seed(0), device="cpu")
    return bge.BGETorchEncoder(params=params, **kw)


def _bge_init_params(tmp_path, **kw):
    return bge.init_params(bge.EncoderArch.tiny(), torch.Generator().manual_seed(0), **kw)


def _bge_params_from_jax(tmp_path, **kw):
    arch = bge.EncoderArch.tiny()
    ref = bge.init_params(arch, torch.Generator().manual_seed(0), device="cpu")
    tree = {"embed": {n: getattr(ref, n).numpy() for n in ("word", "position", "token_type", "ln_scale", "ln_bias")},
            "layers": {n: np.stack([getattr(layer, n).numpy() for layer in ref.layers])
                       for n, _ in ref.layers[0].named_parameters()}}
    return bge.params_from_jax(tree, arch, **kw)


def _bge_hf_checkpoint(tmp_path, **kw):
    from transformers import BertConfig, BertModel

    path = tmp_path / "tiny_bert"
    if not path.exists():
        torch.manual_seed(0)
        BertModel(BertConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                             intermediate_size=32, max_position_embeddings=16)).save_pretrained(path)
    return bge.load_hf_checkpoint(str(path), **kw)


def _create_train_state(tmp_path, **kw):
    return train.create_train_state(bge.EncoderArch.tiny(), torch.Generator().manual_seed(0), **kw)


def _create_lm_train_state(tmp_path, **kw):
    return train_lm.create_lm_train_state(decoder.DecoderArch.tiny(), torch.Generator().manual_seed(0), **kw)


def _cpu_mesh_or_every_card(shape, device):
    """The mesh a caller builds: every card without a device (``build_mesh``
    raises without one), the named device repeated otherwise."""
    from comorag_torch.parallel.mesh import build_mesh

    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, None if device is None else [torch.device(device)] * n)


def _create_train_state_over_a_mesh(tmp_path, device=None):
    """A sharded state names no device: it lives on the mesh's devices."""
    mesh = _cpu_mesh_or_every_card({"data": 2, "model": 2}, device)
    return train.create_train_state(bge.EncoderArch.tiny(), torch.Generator().manual_seed(0), mesh=mesh)


def _create_lm_train_state_over_a_mesh(tmp_path, device=None):
    mesh = _cpu_mesh_or_every_card({"data": 2, "model": 2}, device)
    return train_lm.create_lm_train_state(decoder.DecoderArch.tiny(), torch.Generator().manual_seed(0), mesh=mesh)


def _hf_checkpoint(tmp_path, **kw):
    from transformers import LlamaConfig, LlamaForCausalLM

    path = tmp_path / "tiny_llama"
    cfg = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                      num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64)
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).save_pretrained(path)
    return decoder.load_hf_decoder_checkpoint(str(path), **kw)


def _points(n=24, d=6):
    return np.random.default_rng(0).standard_normal((n, d)).astype(np.float32)


def _fit_gmm_bic(tmp_path, **kw):
    k, resp = fit_gmm_bic(_points(), max_clusters=3, iters=5, **kw)
    assert resp.shape == (24, k) and np.allclose(resp.sum(axis=1), 1.0, atol=1e-4)


def _two_level_soft_cluster(tmp_path, **kw):
    clusters = two_level_soft_cluster(_points(), reduction_dim=4, max_clusters=3, em_iters=5, **kw)
    assert clusters and all(c.members for c in clusters)


def _add_synonymy_edges(tmp_path, **kw):
    embs = np.repeat(np.eye(3, 8, dtype=np.float32), 2, axis=0)  # three pairs of synonyms
    keys = [f"entity-{i}" for i in range(6)]
    assert GraphBuilder().add_synonymy_edges(keys, keys, embs, topk=4, **kw) == 6  # each pair, both ways


def _decoder_init_params(tmp_path, **kw):
    return decoder.init_params(decoder.DecoderArch.tiny(), torch.Generator().manual_seed(0), **kw)


def _decoder_params_from_jax(tmp_path, **kw):
    tree = {"embed": np.ones((4, 2), np.float32),
            "layers": {"qkv_w": decoder.QuantWeight(np.ones((2, 3), np.int8), np.ones((1, 3), np.float32))}}
    return decoder.params_from_jax(tree, **kw)


def _kv_cache(tmp_path, **kw):
    return decoder.KVCache.zeros(decoder.DecoderArch.tiny(), 2, 8, **kw)


def _make_kv_cache_bf16(tmp_path, **kw):
    return decoder.make_kv_cache(decoder.DecoderArch.tiny(), 2, 8, torch.bfloat16, **kw)


def _make_kv_cache_int8(tmp_path, **kw):
    cache = decoder.make_kv_cache(decoder.DecoderArch.tiny(), 2, 8, torch.bfloat16, kv_dtype="int8", **kw)
    assert isinstance(cache, decoder.QuantKVCache) and cache.k.dtype == torch.int8
    return cache


def _offline_llm_over_a_mesh(tmp_path, device=None):
    """TorchOfflineLLM(mesh=) names no device: it runs on the mesh's first
    device, so a mesh over the CPU puts it there (and ``build_mesh`` over
    every card raises without one)."""
    from comorag_torch.llm.offline import TorchOfflineLLM
    from comorag_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"model": 2}, None if device is None else [torch.device(device)] * 2)
    engine = TorchOfflineLLM(mesh=mesh)
    assert all(s.device == mesh.device for s in engine.params["layers"]["qkv_w"].shards)
    return engine


def _process_group(tmp_path, device=None):
    """``distributed.initialize`` (a group of one process on a free port):
    its home device, the backend's default for it, then the group is shut."""
    from comorag_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, device=device, timeout_s=30)
    try:
        assert distributed.backend() == ("gloo" if distributed.home_device().type == "cpu" else "nccl")
        return types.SimpleNamespace(device=distributed.home_device())
    finally:
        distributed.shutdown()


ENTRY_POINTS = {
    "BGETorchEncoder": _bge_encoder,
    "TorchOfflineLLM(mesh=)": _offline_llm_over_a_mesh,
    "MipsIndex": _mips_index,
    "RetrievalEngine": _retrieval_engine,
    "PPRGraph": _ppr_graph,
    "distributed.initialize": _process_group,
    "SemanticTree": _semantic_tree,
    "load_hf_decoder_checkpoint": _hf_checkpoint,
    "fit_gmm_bic": _fit_gmm_bic,
    "two_level_soft_cluster": _two_level_soft_cluster,
    "GraphBuilder.add_synonymy_edges": _add_synonymy_edges,
    "decoder.init_params": _decoder_init_params,
    "decoder.params_from_jax": _decoder_params_from_jax,
    "KVCache.zeros": _kv_cache,
    "make_kv_cache": _make_kv_cache_bf16,
    "make_kv_cache(kv_dtype=int8)": _make_kv_cache_int8,
    "bge.init_params": _bge_init_params,
    "bge.params_from_jax": _bge_params_from_jax,
    "bge.load_hf_checkpoint": _bge_hf_checkpoint,
    "train.create_train_state": _create_train_state,
    "train_lm.create_lm_train_state": _create_lm_train_state,
    "train.create_train_state(mesh=)": _create_train_state_over_a_mesh,
    "train_lm.create_lm_train_state(mesh=)": _create_lm_train_state_over_a_mesh,
}
FUNCTIONS = {"fit_gmm_bic", "two_level_soft_cluster", "GraphBuilder.add_synonymy_edges"}  # check their own results
CACHES = {"KVCache.zeros", "make_kv_cache", "make_kv_cache(kv_dtype=int8)"}  # tuples of tensors
TREES = {"decoder.init_params", "decoder.params_from_jax"}  # dicts of tensors and weight tuples
PARAM_SETS = {"bge.init_params", "bge.params_from_jax", "bge.load_hf_checkpoint",  # an Encoder, or a state
              "train.create_train_state", "train_lm.create_lm_train_state", "train.create_train_state(mesh=)",
              "train_lm.create_lm_train_state(mesh=)"}


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from _leaves(v)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, tmp_path, monkeypatch):
    make = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(tmp_path)
    built = make(tmp_path, device="cpu")
    if name in FUNCTIONS:
        assert built is None
    elif name == "load_hf_decoder_checkpoint":
        params, _ = built
        assert params["embed"].device.type == "cpu"
    elif name in CACHES:
        assert all(t.device.type == "cpu" for t in built)
    elif name in TREES:
        leaves = list(_leaves(built))
        assert leaves and all(t.device.type == "cpu" for t in leaves)
    elif name in PARAM_SETS:
        params = built.params if isinstance(built, train.TrainState) else built[0] if isinstance(built, tuple) else built
        leaves = [p for _, p, _ in train.named_leaves(params)]
        assert leaves and all(t.device.type == "cpu" for t in leaves)
    else:
        assert built.device == torch.device("cpu")


def test_build_mesh_without_a_card_raises(monkeypatch):
    """``build_mesh(devices=None)`` means every CUDA device: without a card
    it raises and names the CPU mesh, never falling back to it."""
    from comorag_torch.parallel.mesh import build_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for shape in (None, {"corpus": 4}):
        with pytest.raises(RuntimeError, match=r"devices=\[torch.device\('cpu'\)\]"):
            build_mesh(shape)
    assert build_mesh({"corpus": 4}, [torch.device("cpu")] * 4).shape == {"corpus": 4}


def test_mesh_shape_over_too_few_cards_raises(monkeypatch, tmp_path):
    """``ComoRAG(mesh_shape={"corpus": 4})`` on ``device="cuda"`` with one
    card raises JAX's device-count error (nothing falls back to the CPU);
    the card is simulated, and the error comes before any CUDA call."""
    from comorag_torch.comorag import ComoRAG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    config = ComoConfig(mesh_shape={"corpus": 4}, embedding_model_name="hash", save_dir=str(tmp_path))
    with pytest.raises(ValueError, match=r"mesh shape \{'corpus': 4\} needs 4 devices, have 1"):
        ComoRAG(config, device="cuda")


def test_process_mesh_without_a_card_raises(monkeypatch):
    """After ``distributed.initialize`` (two processes, simulated here),
    ``build_mesh(devices=None)`` means this process's every card: without
    one it raises and names the CPU; CPU positions build the process mesh,
    the other process's positions held by placeholders."""
    from comorag_torch.parallel import distributed
    from comorag_torch.parallel.mesh import RemoteDevice, build_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    monkeypatch.setattr(distributed, "backend", lambda: "gloo")
    monkeypatch.setattr(distributed, "all_gather_object", lambda obj: [["cpu", "cpu"], obj])
    with pytest.raises(RuntimeError, match=r"devices=\[torch.device\('cpu'\)\]"):
        build_mesh({"corpus": 4})
    mesh = build_mesh({"corpus": 4}, [torch.device("cpu")] * 2)
    assert mesh.process_count == 2 and mesh.process_index == 1 and mesh.device == torch.device("cpu")
    assert [mesh.is_local(corpus=i) for i in range(4)] == [False, False, True, True]
    assert mesh.axis_devices("corpus")[:2] == [RemoteDevice(0, "cpu")] * 2
