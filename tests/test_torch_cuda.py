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


# the tie-tolerant rule of ops/mips.check_topk: scores to 1e-5 + 1e-5*|plain|,
# ids equal wherever the plain ranking is separated by more than 1e-5
@pytest.mark.parametrize("n", [511, 4096, 70_001])
@pytest.mark.parametrize("p,d,k", [(1, 64, 1), (5, 768, 50), (16, 64, 256), (130, 768, 50),
                                   (16, 768, 256), (130, 64, 1)])
def test_mips_topk_kernels_match_plain(cuda_device, n, p, d, k):
    from comorag_torch.ops import mips
    from comorag_torch.ops.topk import dense_scores, int8_scores, quantize_int8

    rng = np.random.default_rng(n + p + d + k)
    corpus = _normalized(rng, (n, d))
    k = min(k, n)
    q = torch.tensor(_normalized(rng, (p, d)), device=cuda_device)
    c32 = torch.tensor(corpus, device=cuda_device)
    before = mips.LAUNCHES.value
    s, i = mips.mips_topk(q, c32, k)
    torch.cuda.synchronize()
    assert mips.LAUNCHES.value == before + 1
    mips.check_topk(s, i, dense_scores(q, c32), "fp32")
    c16 = c32.to(torch.bfloat16)
    s, i = mips.mips_topk(q, c16, k)
    mips.check_topk(s, i, dense_scores(q, c16), "bf16")
    cq, sc = (torch.tensor(a, device=cuda_device) for a in quantize_int8(corpus))
    before = mips.INT8_LAUNCHES.value
    s, i = mips.mips_topk_int8(q, cq, sc, k)
    torch.cuda.synchronize()
    assert mips.INT8_LAUNCHES.value == before + 1
    mips.check_topk(s, i, int8_scores(q, cq, sc), "int8")


# d % 4 != 0: the scalar load path; 40 queries at d = 64: the wide scan (k <= 64)
@pytest.mark.parametrize("d,p", [(3, 1), (64, 1), (100, 1), (64, 40)])
def test_mips_topk_duplicates_tie_to_lowest_id(cuda_device, d, p):
    from comorag_torch.ops import mips
    from comorag_torch.ops.topk import quantize_int8

    rng = np.random.default_rng(d)
    corpus = _normalized(rng, (5000, d)) * 0.25
    dup_ids = np.sort(rng.choice(5000, 300, replace=False))
    corpus[dup_ids] = corpus[dup_ids[0]] * 4.0
    q = torch.tensor(np.repeat(corpus[dup_ids[:1]] * 2.0, p, axis=0), device=cuda_device)
    for k in (1, 40, 64, 256):
        _, i = mips.mips_topk(q, torch.tensor(corpus, device=cuda_device), k)
        np.testing.assert_array_equal(i.cpu().numpy(), np.tile(dup_ids[:k], (p, 1)))
        cq, sc = (torch.tensor(a, device=cuda_device) for a in quantize_int8(corpus))
        _, i = mips.mips_topk_int8(q, cq, sc, k)
        np.testing.assert_array_equal(i.cpu().numpy(), np.tile(dup_ids[:k], (p, 1)))


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
