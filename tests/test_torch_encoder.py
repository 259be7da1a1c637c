"""comorag_torch's BGE encoder against the JAX encoder on the same weights
(``params_from_jax``) and the same numpy inputs.

Shapes: H=128, 2 heads, I=256, 2 layers, so ``fused_ffn_supported`` holds
and the JAX ``pallas_interpret`` route really runs both Pallas kernels.
Tolerance: fp32 atol 1e-5 on L2-normalized pooled vectors.
"""

import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from comorag_torch.models import bge as tbge
from comorag_tpu.models import bge as jbge

ARCH_KW = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
               intermediate_size=256, max_position=64)


@pytest.fixture(scope="module")
def weights():
    jarch = jbge.EncoderArch(**ARCH_KW)
    params = jax.tree_util.tree_map(np.asarray, jbge.init_params(jax.random.PRNGKey(0), jarch))
    # non-trivial LN affine and biases, so the conversion of every vector shows
    rng = np.random.default_rng(3)
    for group, vector_ndim in ((params["embed"], 1), (params["layers"], 2)):  # layers are stacked
        for name, arr in group.items():
            if arr.ndim == vector_ndim:
                group[name] = (arr + rng.normal(scale=0.05, size=arr.shape)).astype(np.float32)
    return jarch, params, tbge.params_from_jax(params, tbge.EncoderArch(**ARCH_KW), device="cpu")


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(2, ARCH_KW["vocab_size"], (8, 32)).astype(np.int32)
    mask = np.ones((8, 32), np.int32)
    mask[3, 20:] = 0
    mask[7, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("jax_route,torch_route", [("xla", "plain"), ("pallas_interpret", "kernel")])
def test_encode_pooled_matches_jax(weights, jax_route, torch_route):
    jarch, params, model = weights
    ids, mask = _inputs()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(jbge.encode_pooled(jparams, jnp.asarray(ids), jnp.asarray(mask), jarch,
                                        attention=jax_route))
    got = tbge.encode_pooled(model, torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(mask),
                             attention=torch_route).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_encoder_wrapper_matches_jax(weights):
    """Tokenization, bucketing, padding rows and batching agree too."""
    jarch, params, model = weights
    texts = [f"the keeper lit lamp number {i} at dusk" + " again" * (i % 5) for i in range(11)]
    jenc = jbge.BGEJaxEncoder(params=jax.tree_util.tree_map(jnp.asarray, params), arch=jarch,
                              max_seq_len=32, batch_size=4)
    tenc = tbge.BGETorchEncoder(params=model, max_seq_len=32, batch_size=4, device="cpu")
    assert tenc.attention == "plain"
    assert tenc.fingerprint.split(":", 1)[1] == jenc.fingerprint.split(":", 1)[1]
    np.testing.assert_allclose(tenc.encode(texts), jenc.encode(texts), atol=1e-5, rtol=0)
    dev = tenc.encode_device(texts, instruction="query: ")
    assert isinstance(dev, torch.Tensor) and dev.shape == (11, ARCH_KW["hidden_size"])
    np.testing.assert_allclose(dev.numpy(), jenc.encode(texts, instruction="query: "),
                               atol=1e-5, rtol=0)


def test_hf_checkpoint_matches_transformers(tmp_path):
    """Weight conversion from a randomly initialized local BERT checkpoint
    (no download) gives transformers' own pooled embeddings."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=48)
    torch.manual_seed(0)
    hf = transformers.BertModel(cfg).eval()
    hf.save_pretrained(tmp_path / "tiny-bert")
    model, _ = tbge.load_hf_checkpoint(str(tmp_path / "tiny-bert"), device="cpu")
    ids, mask = _inputs()
    ids, mask = ids[:3, :16].astype(np.int64) % 97, mask[:3, :16].astype(np.int64)
    with torch.no_grad():
        hidden = hf(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    ref = (hidden * m).sum(1) / m.sum(1)
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    got = tbge.encode_pooled(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(got - ref).max() < 2e-4
