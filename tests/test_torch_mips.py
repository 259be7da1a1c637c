"""comorag_torch.ops.mips (the streaming top-k kernels' plain versions)
against the JAX Pallas kernels run in interpret mode and the XLA top-k.

The JAX kernels take a corpus padded to whole tiles with ``n_valid`` real
rows and a query batch that is a multiple of 8: the test pads both and
compares the real rows; the port takes true sizes. Tolerances: ids exactly
equal; scores 1e-5 against ``dense_topk`` / ``int8_topk`` (the same fp32
sums in another order); 1e-3 against the interpreted fp32 TPU kernel,
whose bf16x3 split of the fp32 product is not exact (JAX's own test allows
1e-2).
"""

import numpy as np
import pytest
import torch

from comorag_torch.ops import mips
from comorag_torch.ops.topk import dense_scores, exact_topk, quantize_int8
from comorag_tpu.ops.pallas_topk import pallas_mips_topk, pallas_mips_topk_int8
from comorag_tpu.ops.topk import dense_topk, int8_topk
from comorag_tpu.ops.topk import quantize_int8 as jax_quantize_int8
from _tf32_emulation import ROUNDINGS, tf32_scores

P, N_PAD, N_VALID, D, K = 8, 1024, 900, 128, 20


def _normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    corpus = np.zeros((N_PAD, D), np.float32)
    corpus[:N_VALID] = _normalized(rng, (N_VALID, D))
    q = _normalized(rng, (5, D))  # 5 real queries, padded to 8 for the JAX kernels
    q_pad = np.zeros((P, D), np.float32)
    q_pad[:5] = q
    return corpus, q, q_pad


def test_fp32_plain_matches_interpreted_tpu_kernel_and_dense_topk(data):
    corpus, q, q_pad = data
    s, i = mips.mips_topk(torch.as_tensor(q), torch.as_tensor(corpus[:N_VALID]), K)
    sk, ik = pallas_mips_topk(q_pad, corpus, np.int32(N_VALID), K, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ik)[:5])
    np.testing.assert_allclose(s.numpy(), np.asarray(sk)[:5], atol=1e-3, rtol=0)
    sd, idd = dense_topk(q, corpus, np.int32(N_VALID), K)
    np.testing.assert_array_equal(i.numpy(), np.asarray(idd))
    np.testing.assert_allclose(s.numpy(), np.asarray(sd), atol=1e-5, rtol=0)


def test_int8_plain_matches_interpreted_tpu_kernel_and_int8_topk(data):
    corpus, q, q_pad = data
    cq, sc = quantize_int8(corpus[:N_VALID])
    jq, jsc = jax_quantize_int8(corpus)
    np.testing.assert_array_equal(cq, np.asarray(jq)[:N_VALID])
    s, i = mips.mips_topk_int8(torch.as_tensor(q), torch.as_tensor(cq), torch.as_tensor(sc), K)
    sk, ik = pallas_mips_topk_int8(q_pad, jq, jsc.reshape(1, -1), np.int32(N_VALID), K, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ik)[:5])
    np.testing.assert_allclose(s.numpy(), np.asarray(sk)[:5], atol=1e-5, rtol=0)
    sd, idd = int8_topk(q, jq, jsc, np.int32(N_VALID), K)
    np.testing.assert_array_equal(i.numpy(), np.asarray(idd))
    np.testing.assert_allclose(s.numpy(), np.asarray(sd), atol=1e-5, rtol=0)


def test_identical_rows_tie_to_the_lowest_ids():
    """As tests/test_pallas_native.py:54: every row scores the same, so the
    top-k is ids 0..k-1 in order, for fp32, bf16 and int8 rows."""
    corpus = np.ones((300, 16), np.float32)
    q = torch.ones((3, 16))
    for s, i in (mips.mips_topk(q, torch.as_tensor(corpus), 12),
                 mips.mips_topk(q, torch.as_tensor(corpus).to(torch.bfloat16), 12),
                 mips.mips_topk_int8(q, *(torch.as_tensor(a) for a in quantize_int8(corpus)), 12)):
        np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(12), (3, 1)))
        np.testing.assert_allclose(s.numpy(), 16.0, atol=1e-5)
    _, ik = pallas_mips_topk(np.ones((8, 16), np.float32), np.ones((512, 16), np.float32),
                             np.int32(300), 12, interpret=True)
    np.testing.assert_array_equal(np.asarray(ik)[:3], np.tile(np.arange(12), (3, 1)))


def test_cpu_tensors_run_the_plain_version_without_counting(data):
    corpus, q, _ = data
    counters = (mips.LAUNCHES, mips.INT8_LAUNCHES, *mips.ROUTE_LAUNCHES.values())
    before = [c.value for c in counters]
    mips.mips_topk(torch.as_tensor(q), torch.as_tensor(corpus), 5)
    mips.mips_topk_int8(torch.as_tensor(q), *(torch.as_tensor(a) for a in quantize_int8(corpus)), 5)
    assert [c.value for c in counters] == before
    with pytest.raises(ValueError, match="unsupported device"):
        mips.mips_topk(torch.zeros(2, 4, device="meta"), torch.zeros(9, 4, device="meta"), 3)


def test_check_topk_accepts_swapped_near_ties_and_rejects_wrong_ids():
    scores = torch.tensor([[5.0, 3.0, 3.0 + 5e-7, 1.0, 0.0]])
    s, i = torch.tensor([[5.0, 3.0, 3.0]]), torch.tensor([[0, 1, 2]])  # ranks 1-2 swapped
    assert mips.check_topk(s, i, scores, "near tie") <= 1e-6
    with pytest.raises(AssertionError, match="separated"):  # ranks 1-2 are 1.5e-5 apart
        mips.check_topk(torch.tensor([[5.0, 3.0, 3.000015]]), torch.tensor([[0, 1, 2]]),
                        torch.tensor([[5.0, 3.0, 3.000015, 1.0]]), "wrong")
    with pytest.raises(AssertionError, match="twice"):
        mips.check_topk(torch.tensor([[5.0, 3.0]]), torch.tensor([[0, 0]]), scores, "dup")


@pytest.mark.parametrize("row_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_scan_route_table(row_dtype):
    """Every call shape takes one of the three scan routes: int8 rows with
    k <= 64, d % 16 == 0 and aligned rows the bf16 tensor-core scan; fp32
    rows with k <= 64, d % 4 == 0 and aligned rows the 3xTF32 tensor-core
    scan, at every P; every other call the narrow scan."""
    taken = {route: 0 for route in mips.SCAN_ROUTES}
    for p in (1, 16, 31, 32, 256):
        for d in (64, 768, 1000, 1024):
            for k in (1, 50, 64, 65, 256):
                for aligned in (False, True):
                    route = mips.scan_route(p, d, k, row_dtype, aligned)
                    assert route in mips.SCAN_ROUTES, (p, d, k, aligned, route)
                    taken[route] += 1
                    if row_dtype == torch.int8 and k <= 64 and d % 16 == 0 and aligned:
                        assert route == "mma", (p, d, k, aligned, route)
                    elif row_dtype == torch.float32 and k <= 64 and d % 4 == 0 and aligned:
                        assert route == "tf32", (p, d, k, aligned, route)
                    else:
                        assert route == "scan", (p, d, k, aligned, route)
    assert sum(taken.values()) == 5 * 4 * 5 * 2
    # bench shape (d = 1024, k = 50) and bert-base's d = 768 reach the tensor cores at every P
    assert taken["mma"] == (5 * 3 * 3 if row_dtype == torch.int8 else 0)
    assert taken["tf32"] == (5 * 4 * 3 if row_dtype == torch.float32 else 0)
    # d % 4 != 0 keeps fp32 rows on the narrow scan
    assert mips.scan_route(16, 1026, 50, torch.float32, True) == "scan"


def _tf32_case(name: str):
    """(queries [8, d], corpus [N, d], k) of a seeded case: bench.py:53-59's
    normalized rows, un-normalized randn (d = 100, not a multiple of a stage),
    and 300 identical rows among normalized ones."""
    rng = np.random.default_rng(5)
    if name == "normalized":
        return _normalized(rng, (8, 256)), _normalized(rng, (1500, 256)), 50
    if name == "randn":
        return (rng.standard_normal((8, 100)).astype(np.float32),
                rng.standard_normal((1500, 100)).astype(np.float32), 64)
    corpus = _normalized(rng, (1500, 64)) * 0.25
    dup_ids = np.sort(rng.choice(1500, 300, replace=False))
    corpus[dup_ids] = corpus[dup_ids[0]] * 4.0
    return np.repeat(corpus[dup_ids[:1]] * 2.0, 8, axis=0), corpus, 40


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("cross_sum", [False, True])
@pytest.mark.parametrize("case", ["normalized", "randn", "duplicates"])
def test_tf32_route_arithmetic_holds_the_fp32_rule(case, cross_sum, rounding):
    """The 3xTF32 scores of the tf32 scan route, emulated on the CPU in both
    sum orders and with each mma sum rounded to nearest or toward zero,
    rank as the fp32 plain version does: their top-k passes check_topk at
    1e-5, and its ids equal those of JAX's pallas_mips_topk (interpret
    mode) wherever the plain ranking is separated by more than 1e-5;
    identical rows tie to the lowest ids. Observed max |emulated - float64|
    over all scores, one accumulator / the cross terms in a second, to
    nearest; toward zero; the plain fp32 matmul: 9.3e-8 / 4.7e-8; 6.5e-7 /
    2.1e-7; 2.6e-8 on the normalized rows (|score| <= 0.27), 9.7e-6 /
    6.8e-6; 5.3e-5 / 1.8e-5; 1.2e-5 on randn (|score| <= 43), 4.2e-7 /
    1.8e-7; 7.8e-7 / 4.2e-7; 6.2e-8 on the duplicates (<= 2). The card's own
    numerics are witnessed by the CUDA tests (tests/test_torch_cuda.py);
    rounding toward zero is the mode that reproduces their errors
    (scripts/tf32_emulation_error.py)."""
    qn, cn, k = _tf32_case(case)
    q, c = torch.as_tensor(qn), torch.as_tensor(cn)
    s, i = exact_topk(tf32_scores(q, c, cross_sum, rounding), k)
    mips.check_topk(s, i, dense_scores(q, c), f"tf32 emulation, {case}")
    n_pad = -(-len(cn) // 512) * 512
    padded = np.zeros((n_pad, cn.shape[1]), np.float32)
    padded[: len(cn)] = cn
    _, jax_i = pallas_mips_topk(qn, padded, np.int32(len(cn)), k, interpret=True)
    ref_s, _ = exact_topk(dense_scores(q, c), k + 1)
    inf = torch.full_like(ref_s[:, :1], float("inf"))
    gaps = torch.cat([inf, ref_s[:, :-1] - ref_s[:, 1:], inf], dim=1)[:, : k + 1]
    determined = (gaps[:, :k] > 1e-5) & (gaps[:, 1:] > 1e-5)
    assert bool(((i == torch.as_tensor(np.array(jax_i)).long()) | ~determined).all())
    if case == "duplicates":
        dup = np.flatnonzero((cn == cn[i[0, 0]]).all(axis=1))
        np.testing.assert_array_equal(i.numpy(), np.tile(dup[:k], (8, 1)))
