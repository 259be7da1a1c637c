"""The port's public constructors and loaders run on the card unless the
caller asks for the CPU: without a card, a call that names no device
raises and says how to ask for the CPU, and ``device="cpu"`` builds."""

import numpy as np
import pytest
import torch

from comorag_torch.cluster.raptor import SemanticTree
from comorag_torch.config import ComoConfig
from comorag_torch.models import bge, decoder
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
    params = bge.init_params(bge.EncoderArch.tiny(), torch.Generator().manual_seed(0))
    return bge.BGETorchEncoder(params=params, **kw)


def _hf_checkpoint(tmp_path, **kw):
    from transformers import LlamaConfig, LlamaForCausalLM

    path = tmp_path / "tiny_llama"
    cfg = LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                      num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64)
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).save_pretrained(path)
    return decoder.load_hf_decoder_checkpoint(str(path), **kw)


ENTRY_POINTS = {
    "BGETorchEncoder": _bge_encoder,
    "MipsIndex": _mips_index,
    "RetrievalEngine": _retrieval_engine,
    "PPRGraph": _ppr_graph,
    "SemanticTree": _semantic_tree,
    "load_hf_decoder_checkpoint": _hf_checkpoint,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, tmp_path, monkeypatch):
    make = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(tmp_path)
    built = make(tmp_path, device="cpu")
    if name == "load_hf_decoder_checkpoint":
        params, _ = built
        assert params["embed"].device.type == "cpu"
    else:
        assert built.device == torch.device("cpu")
