"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip on hosts without a card. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is compiled with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Lq,Lk,D,H,dtype", [
    (8, 129, 129, 768, 12, torch.bfloat16),   # the ViT-B blocks' shape
    (8, 129, 129, 768, 12, torch.float32),
    (4, 3, 384, 512, 8, torch.float32),       # cross attention, Lq != Lk
    (4, 9, 9, 384, 6, torch.bfloat16),        # odd: 6 heads of 64
    (2, 17, 33, 256, 2, torch.float32),       # hd 128, ragged lengths
])
def test_attention_kernel_matches_plain_version(cuda_device, B, Lq, Lk, D, H, dtype):
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda, flash_attention_reference

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(B, Lq, D, device=cuda_device, generator=gen).to(dtype)
    k = torch.randn(B, Lk, D, device=cuda_device, generator=gen).to(dtype)
    v = torch.randn(B, Lk, D, device=cuda_device, generator=gen).to(dtype)
    before = attention_fwd_cuda.launches
    got = attention_fwd_cuda(q, k, v, H)
    torch.cuda.synchronize()
    assert attention_fwd_cuda.launches == before + 1
    want = flash_attention_reference(q, k, v, H)
    # fp32: summation order only; bf16: one bf16 ulp of |o| < 4
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=1.6e-2, rtol=0)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


def test_attention_kernel_rejects_what_it_cannot_take(cuda_device):
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    q = torch.zeros(1, 4, 12 * 4, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        attention_fwd_cuda(q, q, q, 12)                   # hd = 4
    q = torch.zeros(1, 4, 256, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        attention_fwd_cuda(q, q, q, 4)
    q = torch.zeros(1, 4, 64, device=cuda_device)
    kv = torch.zeros(1, 4000, 64, device=cuda_device)
    with pytest.raises(ValueError, match="shared"):
        attention_fwd_cuda(q, kv, kv, 1)                  # Lk beyond shared memory
