"""comorag_torch.graft_entry, the port's root harness, against
``__graft_entry__.py`` on the CPU.

``entry()``'s forward is held against JAX's on the same numpy weights (JAX's
own ``entry()`` arguments, converted by ``bge.params_from_jax``) within
tests/test_torch_encoder.py's tolerance, atol 1e-5, rtol 0. ``_factor_mesh``
equals JAX's. ``dryrun_multichip`` runs its whole sequence over CPU
positions (its checks raise), and refuses to fall back to the CPU without
a card. The run over distinct cards is a CUDA test
(tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from comorag_torch import graft_entry
from comorag_torch.models import bge as tbge

CPU = torch.device("cpu")


def test_entry_matches_jax_entry_on_the_same_weights():
    jfn, (jparams, jids, jmask) = jentry.entry()
    ref = np.asarray(jax.jit(jfn)(jparams, jids, jmask))
    fn, (model, ids, mask) = graft_entry.entry(device="cpu")
    assert model.word.device == CPU and tuple(ids.shape) == tuple(mask.shape) == (8, 128)
    own = fn(model, ids, mask)
    assert own.dtype == torch.float32 and tuple(own.shape) == (8, 768) and not own.requires_grad
    np.testing.assert_allclose(own.norm(dim=-1).numpy(), 1.0, atol=1e-5, rtol=0)
    jax_model = tbge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), graft_entry.ENTRY_ARCH, "cpu")
    got = fn(jax_model, ids, mask).numpy()
    assert ref.shape == got.shape == (8, 768)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_matches_jax(n):
    assert graft_entry._factor_mesh(n) == jentry._factor_mesh(n)


# 8: {"data": 2, "model": 4}, the JAX driver's call; 5: {"data": 5, "model": 1},
# whose weights stay whole
@pytest.mark.parametrize("n", [8, 5])
def test_dryrun_multichip_over_cpu_positions(n):
    out = graft_entry.dryrun_multichip(n, devices=[CPU] * n)
    assert out["mesh"] == jentry._factor_mesh(n)
    assert np.isfinite(out["loss"]) and np.isfinite(out["lm_loss"])
    assert out["speculative_decode_steps"] >= 1 and out["int4_decode_steps"] >= 1
    assert all(isinstance(t, str) for t in out["texts"].values()) and out["int8_text_bytes"] > 0
    assert out["topk_shape"] == [4, 8] and np.isfinite(out["ppr_sum"])
    assert out["devices"] == ["cpu"] * n
    # the CPU launches no kernel: the wrappers run their plain versions
    assert out["int4_matmul_launches"] == 0 and not any(out["train_launches"].values())


@pytest.mark.parametrize("call", [lambda: graft_entry.dryrun_multichip(8), lambda: graft_entry.entry()],
                         ids=["dryrun_multichip", "entry"])
def test_no_card_raises_rather_than_running_on_the_cpu(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()


@pytest.mark.parametrize("count", [7, 9])
def test_dryrun_multichip_takes_one_device_a_position(count):
    with pytest.raises(ValueError, match="needs 8 devices"):
        graft_entry.dryrun_multichip(8, devices=[CPU] * count)
