"""Full-covariance Gaussian mixture EM with a batched BIC sweep, in torch.

Port of ``comorag_tpu/ops/gmm.py`` ``fit_gmm_bic`` (:161). As in JAX, ONE
batched program fits every candidate k = 1..k_max at once: model m keeps
its first m+1 of k_max components active (inactive ones get -inf
log-weight and stay inert), so the reference's 50 sequential sklearn fits
become one EM over a leading model axis (JAX vmaps it; here it is an
explicit batch dimension). Covariance ridge 1e-6 (sklearn's reg_covar).
Initial means come from the same numpy draw as the JAX package
(``_init_means_for_sweep``), so both start from identical means.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from comorag_torch.device import resolve_device
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)

_REG = 1e-6


def _log_gauss(x: torch.Tensor, means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """log N(x | mu_mk, Sigma_mk) for every model m, point n, component k:
    x [n, d], means [M, K, d], covs [M, K, d, d] -> [M, n, K]."""
    d = x.shape[1]
    chol = torch.linalg.cholesky(covs)                           # [M, K, d, d]
    diff = x[None, None, :, :] - means[:, :, None, :]            # [M, K, n, d]
    z = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2), upper=False)  # [M, K, d, n]
    maha = (z * z).sum(dim=2).transpose(1, 2)                    # [M, n, K]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)  # [M, K]
    return -0.5 * (maha + logdet[:, None, :] + d * math.log(2.0 * math.pi))


def _sweep(x: torch.Tensor, init_means: torch.Tensor, iters: int):
    """EM for every model of the sweep at once (gmm.py:71 ``_em_single``
    batched over models). Returns (means, covs, log_weights, bic)."""
    n, d = x.shape
    k_max = init_means.shape[0]
    dev = x.device
    comp_mask = torch.arange(1, k_max + 1, device=dev)[:, None] > torch.arange(k_max, device=dev)[None, :]
    k_active = comp_mask.sum(dim=1).to(torch.float32)           # [M]
    eye = torch.eye(d, device=dev)

    mean_all = x.sum(dim=0) / max(n, 1)
    xc = x - mean_all
    cov_all = xc.T @ xc / max(n, 1) + _REG * eye

    means = torch.where(comp_mask[:, :, None], init_means, torch.zeros_like(init_means))
    covs = cov_all.expand(k_max, k_max, d, d).clone()
    neg_inf = torch.tensor(-math.inf, device=dev)
    logw = torch.where(comp_mask, -torch.log(k_active)[:, None], neg_inf)

    ll = torch.zeros(k_max, device=dev)
    for _ in range(iters):
        log_prob = _log_gauss(x, means, covs) + logw[:, None, :]       # [M, n, K]
        log_prob = torch.where(comp_mask[:, None, :], log_prob, neg_inf)
        log_norm = torch.logsumexp(log_prob, dim=2, keepdim=True)      # [M, n, 1]
        resp = torch.exp(log_prob - log_norm)                          # [M, n, K]
        nk = resp.sum(dim=1)                                           # [M, K]
        safe_nk = nk.clamp_min(1e-10)
        new_means = resp.transpose(1, 2) @ x / safe_nk[:, :, None]     # [M, K, d]
        diff = x[None, None, :, :] - new_means[:, :, None, :]          # [M, K, n, d]
        weighted = diff * resp.transpose(1, 2)[:, :, :, None]
        new_covs = weighted.transpose(-1, -2) @ diff / safe_nk[:, :, None, None] + _REG * eye
        logw = torch.where(comp_mask, torch.log(safe_nk) - math.log(max(n, 1)), neg_inf)
        means = torch.where(comp_mask[:, :, None], new_means, torch.zeros_like(new_means))
        covs = torch.where(comp_mask[:, :, None, None], new_covs, eye.expand_as(new_covs))
        ll = log_norm[:, :, 0].sum(dim=1)
    n_params = k_active * d + k_active * d * (d + 1) / 2.0 + (k_active - 1.0)
    bic = -2.0 * ll + n_params * math.log(max(n, 1))
    return means, covs, logw, bic


def _init_means_for_sweep(x: np.ndarray, k_max: int, seed: int) -> np.ndarray:
    """Per-model init: model k uses the first k of a shuffled point sample
    (numpy, identical to gmm.py:149)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    inits = np.zeros((k_max, k_max, x.shape[1]), np.float32)
    for k in range(1, k_max + 1):
        pick = rng.choice(n, size=k, replace=k > n)
        inits[k - 1, :k] = x[pick]
    return inits


def fit_gmm_bic(
    x: np.ndarray,
    max_clusters: int = 50,
    iters: int = 60,
    seed: int = 224,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[int, np.ndarray]:
    """Sweep k = 1..min(max_clusters, n-1), select by BIC, return
    (best_k, soft memberships [n, best_k]) as in gmm.py:161. Runs on the
    card unless ``device="cpu"``; without a card the default raises."""
    device = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, _ = x.shape
    if n <= 1:
        return 1, np.ones((n, 1), np.float32)
    k_max = max(1, max_clusters)  # the full sweep, so the numpy init draws match JAX's
    k_valid = max(1, min(max_clusters, n - 1))
    xt = torch.as_tensor(x, device=device)
    init = torch.as_tensor(_init_means_for_sweep(x, k_max, seed), device=xt.device)
    means, covs, logw, bic = _sweep(xt, init, iters)
    bics = bic.cpu().numpy().astype(np.float64)
    bics[k_valid:] = np.inf  # k > n-1: over-parameterized, not candidates
    bics[~np.isfinite(bics)] = np.inf
    if not np.isfinite(bics).any():
        logger.warning("GMM BIC sweep: every candidate model diverged (non-finite BICs) — "
                       "falling back to one all-points cluster")
        return 1, np.ones((n, 1), np.float32)
    best = int(np.argmin(bics))
    log_prob = _log_gauss(xt, means[best : best + 1], covs[best : best + 1])[0] + logw[best][None, :]
    resp = torch.exp(log_prob - torch.logsumexp(log_prob, dim=1, keepdim=True))
    out = resp.cpu().numpy()[:, : best + 1]
    if not np.isfinite(out).all():
        logger.warning("GMM posterior is non-finite for the BIC-selected model — "
                       "falling back to one all-points cluster")
        return 1, np.ones((n, 1), np.float32)
    return best + 1, out
