"""comorag_torch's kernel modules against the JAX package's Pallas kernels
(interpret mode on the CPU), on the same numpy inputs.

On CPU tensors the port's wrappers run their plain PyTorch versions, so
these tests pin the arithmetic the Hopper kernels are held to on the card
(tests/test_torch_cuda.py). Tolerances: fp32 1e-5 for attention and 1e-4
for the FFN (the TPU kernel's A&S erf polynomial is good to 1.5e-7 per
GELU, amplified through the second product and LN2); bf16 2e-2, as
tests/test_tpu_compiled.py holds the TPU kernels.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from comorag_torch.ops import attention, ffn
from comorag_tpu.ops.pallas_attention import flash_encoder_attention
from comorag_tpu.ops.pallas_ffn import fused_encoder_ffn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_matches_pallas_interpret(dtype, atol):
    jdt, tdt = DTYPES[dtype]
    b, s, h, heads = 2, 64, 128, 2
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[1, 37:] = 0  # ragged: padded keys must be invisible
    ref = flash_encoder_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                  jnp.asarray(mask), num_heads=heads, interpret=True)
    before = attention.LAUNCHES.value
    got = attention.encoder_attention(torch.tensor(q, dtype=tdt), torch.tensor(k, dtype=tdt),
                                      torch.tensor(v, dtype=tdt), torch.tensor(mask), heads)
    assert attention.LAUNCHES.value == before  # CPU tensors never launch the kernel
    assert got.dtype == tdt and got.shape == (b, s, h)
    np.testing.assert_allclose(_as_f32(got), _as_f32(ref), atol=atol, rtol=atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_ffn_matches_pallas_interpret(dtype, atol):
    jdt, tdt = DTYPES[dtype]
    n, h, inter = 128, 128, 256
    rng = np.random.default_rng(1)
    xres = rng.standard_normal((n, h)).astype(np.float32)
    w1 = rng.normal(scale=0.05, size=(h, inter)).astype(np.float32)
    w2 = rng.normal(scale=0.05, size=(inter, h)).astype(np.float32)
    b1 = rng.normal(scale=0.05, size=inter).astype(np.float32)
    b2 = rng.normal(scale=0.05, size=h).astype(np.float32)
    s1, s2 = (rng.normal(1.0, 0.1, h).astype(np.float32) for _ in range(2))
    n1, n2 = (rng.normal(0.0, 0.1, h).astype(np.float32) for _ in range(2))
    ref = fused_encoder_ffn(jnp.asarray(xres, jdt), s1, n1, jnp.asarray(w1, jdt), b1,
                            jnp.asarray(w2, jdt), b2, s2, n2, interpret=True)
    t = torch.tensor
    before = ffn.LAUNCHES.value
    got = ffn.encoder_ffn(t(xres, dtype=tdt), t(s1), t(n1), t(w1, dtype=tdt), t(b1),
                          t(w2, dtype=tdt), t(b2), t(s2), t(n2))
    assert ffn.LAUNCHES.value == before
    assert got.dtype == tdt and got.shape == (n, h)
    np.testing.assert_allclose(_as_f32(got), _as_f32(ref), atol=atol, rtol=atol)


def test_kernel_wrappers_validate_before_launch():
    """Shape support is decided in Python (the CPU can check it): the FFN
    kernel takes hidden sizes that are multiples of 128 up to 1024 and
    intermediate sizes that are multiples of 128."""
    assert ffn.fused_ffn_supported(768, 3072)
    assert ffn.fused_ffn_supported(128, 256)
    assert not ffn.fused_ffn_supported(96, 256)
    assert not ffn.fused_ffn_supported(2048, 8192)
    assert not ffn.fused_ffn_supported(128, 200)
