"""comorag_torch's GMM BIC sweep and projection against the JAX package's,
on seeded 3-blob data: the same chosen k and hard labels, memberships and
the selected model's means within 1e-3 (both run fp32 EM from the same
numpy initial means; their sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import torch

from comorag_torch.ops import gmm as tgmm
from comorag_torch.ops.projection import random_projection as t_proj
from comorag_tpu.ops import gmm as jgmm
from comorag_tpu.ops.projection import random_projection as j_proj


def _blobs(seed=0, n_per=40, centers=((0, 0), (8, 8), (-8, 6))):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(loc=c, scale=0.6, size=(n_per, 2)) for c in centers]
    return np.concatenate(xs).astype(np.float32), np.repeat(np.arange(len(centers)), n_per)


def test_fit_gmm_bic_matches_jax():
    x, labels = _blobs()
    kt, rt = tgmm.fit_gmm_bic(x, max_clusters=8, iters=50, seed=224, device="cpu")
    kj, rj = jgmm.fit_gmm_bic(x, max_clusters=8, iters=50, seed=224)
    assert kt == kj == 3
    np.testing.assert_array_equal(rt.argmax(axis=1), rj.argmax(axis=1))
    np.testing.assert_allclose(rt, rj, atol=1e-3)
    for blob in range(3):
        hard = rt.argmax(axis=1)[labels == blob]
        assert (hard == hard[0]).all()

    init = jgmm._init_means_for_sweep(x, 8, 224)
    np.testing.assert_array_equal(init, tgmm._init_means_for_sweep(x, 8, 224))
    means_t, _, _, bic_t = tgmm._sweep(torch.as_tensor(x), torch.as_tensor(init), 50)
    fits = jgmm._sweep(jnp.asarray(x), jnp.ones(len(x), bool), jnp.asarray(init), 8, 50)
    np.testing.assert_allclose(means_t[kt - 1].numpy(), np.asarray(fits.means[kj - 1]), atol=1e-3)
    assert int(np.argmin(bic_t.numpy())) == int(np.argmin(np.asarray(fits.bic)))


def test_tiny_inputs_and_projection_match_jax():
    assert tgmm.fit_gmm_bic(np.zeros((1, 4), np.float32), device="cpu")[0] == 1
    x = np.random.default_rng(2).standard_normal((30, 64)).astype(np.float32)
    np.testing.assert_array_equal(t_proj(x, 10, seed=224), j_proj(x, 10, seed=224))
    kt, rt = tgmm.fit_gmm_bic(t_proj(x, 10), max_clusters=5, iters=20, device="cpu")
    kj, rj = jgmm.fit_gmm_bic(j_proj(x, 10), max_clusters=5, iters=20)
    assert kt == kj
    np.testing.assert_array_equal(rt >= 0.01, rj >= 0.01)  # the semantic tree's membership rule
