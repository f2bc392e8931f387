"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip on hosts without a card. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# the bf16 kernels pad rows and the head dim to multiples of 16: every
# length at or next to a tile edge, at head dims 8 and 24 (a zero-padded
# contraction), 64 and 128; cross attention both ways. The forward's
# one-pass kernel holds 64, 144, 224 or 256 keys of a row in registers
# (143-145, 208-225, 255-256) and gives way to the long route past 256
# (257); the backward's fused kernel takes up to 160 (159-161), holding 136
# or 160 keys of a row (136-137)
_EDGE_LENGTHS = [(n, n) for n in (1, 15, 16, 17, 129, 136, 137, 143, 144, 145, 159, 160, 161, 192, 193,
                                  *range(208, 226), 255, 256, 257)] + [
    (1, 145), (145, 1), (17, 129), (129, 16), (15, 17), (17, 256), (256, 17), (3, 257),
    (257, 3)]
_EDGES = [(2, lq, lk, 2 * hd, 2, torch.bfloat16)
          for hd in (8, 24, 64, 128) for lq, lk in _EDGE_LENGTHS]
# past 160 tokens the bf16 backward takes its long route: lengths across
# its 64-row tiles, STRIDE_SIZE 12's 211 and a 384×128 input's 193, and
# cross attention both ways
_LONG_EDGES = [(2, lq, lk, 2 * hd, 2, torch.bfloat16) for hd in (64, 128)
               for lq, lk in [(n, n) for n in (161, 176, 193, 211, 223, 256)]
               + [(211, 129), (129, 211)]]
# the long route's own edges: one past a ring chunk of 32 queries (193,
# 225), one past a block's keys, where the cluster grows by a block (256
# keys a block at hd 64: 257, 513, 769; 128 at hd 128: 385, 641, 897 too),
# its longest (1024 keys), and a single key or query against many
_LONG_TILE_EDGES = [(2, lq, lk, 2 * hd, 2, torch.bfloat16) for hd in (64, 128)
                    for lq, lk in [(n, n) for n in (225, 257, 385, 513, 641, 769, 897, 1024)]
                    + [(257, 1), (1, 257), (1024, 17), (17, 1024)]]

# the bf16 forward's long route past 256 keys (K and V streamed in chunks
# of 64 keys through a ring of four stages at hd <= 64, three past it; each
# chunk loaded three times: K twice, V once; a block takes 64 query rows):
# one past 256, a 384×128 input's 311 tokens, each side of a chunk's edge
# as the ring wraps (320, 321, 383-385, 447-449, 511-513, 575-577,
# 768-769), its 1024 keys, and 1 or 3 queries (a block's rows nearly all
# past Lq) and 17 or 145 (a block's last tiles past Lq) against many keys,
# at head dims 8, 64 and 128
_LONG_FWD_EDGES = [(2, lq, lk, 2 * hd, 2, torch.bfloat16) for hd in (8, 64, 128)
                   for lq, lk in [(n, n) for n in (257, 311, 320, 321, 383, 384, 385, 447, 448,
                                                   449, 511, 512, 513, 575, 576, 577, 768, 769,
                                                   1024)]
                   + [(1, 1024), (3, 1024), (3, 384), (17, 1024), (145, 300), (1024, 300)]]

# the fp32 kernels (the forward's keys streamed in chunks of 32, the
# backward's keys or queries in chunks of 16): every bf16 edge length, the
# rings' wraps (31-33, 48-49) and a thousand keys or queries against one,
# at head dims 64 and 128
_FP32_EDGES = [(2, lq, lk, 2 * hd, 2, torch.float32) for hd in (64, 128)
               for lq, lk in _EDGE_LENGTHS + [(n, n) for n in (31, 32, 33, 48, 49)]
               + [(1, 1000), (1000, 1)]]

# a tensor-parallel rank's head group of the CLIP tower (PARALLEL.MODEL_AXIS
# 2: 6 heads, D 384; 4: 3 heads, D 192), at 129 tokens and at STRIDE_SIZE
# 12's 211 (the backward's long route)
_TP_SHAPES = [(8, L, L, 64 * heads, heads, dtype) for heads in (6, 3) for L in (129, 211)
              for dtype in (torch.bfloat16, torch.float32)]

# a pipeline stage's microbatch (PARALLEL.PIPE_AXIS, the flagship tower at
# a global batch of 16: 3B/(dp·M) rows of 6, 12 or 24 at 129 tokens, 12 at
# STRIDE_SIZE 12's 211)
_PIPE_SHAPES = [(rows, L, L, 768, 12, dtype) for rows, L in ((6, 129), (12, 129), (24, 129),
                                                             (12, 211))
                for dtype in (torch.bfloat16, torch.float32)]


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
    (8, 129, 129, 384, 6, torch.bfloat16),    # deit_small's blocks: D 384, 6 heads
    (8, 129, 129, 384, 6, torch.float32),
    (128, 129, 129, 768, 12, torch.bfloat16),  # CLIP-ReID's eval: one modality, B 128
    (128, 129, 129, 768, 12, torch.float32),
    (64, 129, 129, 768, 12, torch.bfloat16),  # and its train step, B 64
    (64, 129, 129, 768, 12, torch.float32),
    (2, 17, 33, 256, 2, torch.float32),       # hd 128, ragged lengths
    (4, 3, 384, 512, 8, torch.bfloat16),      # keys past a register row: the long route
    (2, 17, 300, 256, 2, torch.bfloat16),     # the same at hd 128
    (8, 311, 311, 768, 12, torch.bfloat16),   # a 384×128 input at STRIDE_SIZE 12
    # fewer heads than the card's 132 SMs: the one-pass kernel spreads a
    # head's query tiles over a cluster that shares its K and V
    (3, 211, 211, 768, 12, torch.bfloat16),
    (1, 129, 129, 768, 12, torch.bfloat16),
    (2, 193, 193, 384, 6, torch.bfloat16),
    (1, 256, 256, 512, 4, torch.bfloat16),
    *_TP_SHAPES,
    *_PIPE_SHAPES,
    *_EDGES,
    *_LONG_FWD_EDGES,
    *_FP32_EDGES,
    # bf16's long route takes any length
    (1, 4, 4000, 64, 1, torch.bfloat16),
    (1, 4, 4000, 128, 1, torch.bfloat16),
    # fp32: the most keys one warp's rows of logits fit, at hd 64 and 128
    (1, 4, 3264, 64, 1, torch.float32),
    (1, 4, 2944, 128, 1, torch.float32),
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
    # bf16: past 256 keys the long route, which streams the keys and takes
    # any length (its values at 4000 keys: test_attention_kernel_matches_plain_version)
    before = attention_fwd_cuda.launches_long
    attention_fwd_cuda(q.bfloat16(), kv.bfloat16(), kv.bfloat16(), 1)
    torch.cuda.synchronize()
    assert attention_fwd_cuda.launches_long == before + 1


def test_attention_fwd_routes_by_keys(cuda_device):
    """bf16 up to 256 keys takes the one-pass kernel, past them the long
    route (counted in ``launches_long`` too), at any length; fp32 its
    own."""
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for Lk, dtype, long_route in ((256, torch.bfloat16, 0), (129, torch.bfloat16, 0),
                                  (257, torch.bfloat16, 1), (311, torch.bfloat16, 1),
                                  (1024, torch.bfloat16, 1), (4000, torch.bfloat16, 1),
                                  (300, torch.float32, 0)):
        q = torch.randn(2, 9, 128, device=cuda_device, generator=gen).to(dtype)
        kv = torch.randn(2, Lk, 128, device=cuda_device, generator=gen).to(dtype)
        before = (attention_fwd_cuda.launches, attention_fwd_cuda.launches_long,
                  attention_fwd_cuda.launches_fp32)
        attention_fwd_cuda(q, kv, kv, 2)
        torch.cuda.synchronize()
        assert (attention_fwd_cuda.launches - before[0],
                attention_fwd_cuda.launches_long - before[1],
                attention_fwd_cuda.launches_fp32 - before[2]) == \
            (1, long_route, dtype == torch.float32), (Lk, dtype)


@pytest.mark.parametrize("B, L, counter", [
    (192, 211, "launches"),       # the one-pass kernel at STRIDE_SIZE 12's train shape
    (4, 311, "launches_long"),    # the long route at a 384×128 input's STRIDE_SIZE 12
])
def test_attention_fwd_repeats_to_the_bit(cuda_device, B, L, counter):
    """The one-pass kernel and the long route sum in one fixed order, with
    no atomics (each block's warps own their query tiles; the long route's
    ring only orders the copies): two launches give the same bits."""
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn(B, L, 768, device=cuda_device, generator=gen).bfloat16()
               for _ in "qkv")
    before = getattr(attention_fwd_cuda, counter)
    first = attention_fwd_cuda(q, k, v, 12)
    second = attention_fwd_cuda(q, k, v, 12)
    torch.cuda.synchronize()
    assert getattr(attention_fwd_cuda, counter) == before + 2
    assert torch.equal(first, second)


def test_attention_fwd_kernel_refuses_a_graph(cuda_device):
    """The forward kernel's output has no grad_fn: called directly under
    grad mode with an input that requires grad, the wrapper raises."""
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    q = torch.zeros(2, 9, 128, device=cuda_device, requires_grad=True)
    kv = torch.zeros(2, 9, 128, device=cuda_device)
    with pytest.raises(RuntimeError, match="grad_fn"):
        attention_fwd_cuda(q, kv, kv, 2)
    with torch.no_grad():
        attention_fwd_cuda(q, kv, kv, 2)


@pytest.mark.parametrize("B,Lq,Lk,D,H,dtype", [
    (8, 129, 129, 768, 12, torch.bfloat16),   # the ViT-B blocks' shape
    (8, 129, 129, 768, 12, torch.float32),
    (4, 3, 129, 512, 8, torch.float32),       # cross attention, Lq < Lk
    (4, 40, 7, 512, 8, torch.bfloat16),       # cross attention, Lq > Lk
    (4, 9, 9, 384, 6, torch.bfloat16),        # odd: 6 heads of 64
    (8, 129, 129, 384, 6, torch.bfloat16),    # deit_small's blocks: D 384, 6 heads
    (8, 129, 129, 384, 6, torch.float32),
    (64, 129, 129, 768, 12, torch.bfloat16),  # CLIP-ReID's train step: one modality, B 64
    (64, 129, 129, 768, 12, torch.float32),
    (2, 17, 33, 256, 2, torch.float32),       # hd 128, ragged lengths
    (2, 160, 160, 256, 2, torch.bfloat16),    # the longest the fused bf16 kernel takes
    (4, 211, 211, 768, 12, torch.bfloat16),   # STRIDE_SIZE 12: the long route
    (2, 640, 640, 128, 2, torch.bfloat16),    # the first long route's longest at hd 64
    (2, 288, 288, 256, 2, torch.bfloat16),    # and at hd 128
    *_TP_SHAPES,
    *_PIPE_SHAPES,
    *_EDGES,
    *_LONG_EDGES,
    *_LONG_TILE_EDGES,
    *_FP32_EDGES,
    (1, 4, 1000, 64, 1, torch.float32),       # the fp32 backward takes any length
])
def test_attention_bwd_kernel_matches_plain_version(cuda_device, B, Lq, Lk, D, H, dtype):
    from signal_tpu_torch.ops.flash_attention import (
        attention_bwd_cuda,
        flash_attention_bwd_reference,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, g = (torch.randn(B, Lq, D, device=cuda_device, generator=gen).to(dtype) for _ in "qg")
    k, v = (torch.randn(B, Lk, D, device=cuda_device, generator=gen).to(dtype) for _ in "kv")
    before = attention_bwd_cuda.launches
    got = attention_bwd_cuda(q, k, v, g, H)
    torch.cuda.synchronize()
    assert attention_bwd_cuda.launches == before + 1
    want = flash_attention_bwd_reference(q, k, v, g, H)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if dtype == torch.float32:
            # summation order only
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=name)
        else:
            # dS is rounded to bf16 before dQ/dK: a different fp32 order of
            # dP·P can tip an element across a bf16 rounding boundary, and
            # the outputs are bf16. On randn inputs the gradients are ~0.15
            # and peak at 2-3: two ulps of |x| < 1 (2 · 2^-8) absolute, and
            # rtol 1e-2 (one ulp is 2^-8 to 2^-7 of the value) above
            np.testing.assert_allclose(a, b, atol=8e-3, rtol=1e-2, err_msg=name)


def test_attention_bwd_kernel_rejects_what_it_cannot_take(cuda_device):
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda

    before = attention_bwd_cuda.launches
    for Lk, hd in ((1040, 64), (1040, 128)):
        # past the long route's bound: 1024 keys (a cluster of 8 blocks of
        # 128 keys) at any head dim
        qh = torch.zeros(1, 4, hd, device=cuda_device, dtype=torch.bfloat16)
        kv = torch.zeros(1, Lk, hd, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="at most 1024 keys"):
            attention_bwd_cuda(qh, kv, kv, qh, 1)
    assert attention_bwd_cuda.launches == before


@pytest.mark.parametrize("B", [192, 3])
def test_attention_bwd_fused_repeats_to_the_bit(cuda_device, B):
    """The fused kernel sums in one fixed order, with no atomics (a
    cluster's blocks share out whole tiles and exchange only the rows'
    statistics): two launches at the flagship step's shape and at a
    pipeline microbatch's few heads give the same bits."""
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, g = (torch.randn(B, 129, 768, device=cuda_device, generator=gen).bfloat16()
                  for _ in "qkvg")
    before = (attention_bwd_cuda.launches, attention_bwd_cuda.launches_long)
    first = attention_bwd_cuda(q, k, v, g, 12)
    second = attention_bwd_cuda(q, k, v, g, 12)
    torch.cuda.synchronize()
    assert (attention_bwd_cuda.launches - before[0],
            attention_bwd_cuda.launches_long - before[1]) == (2, 0)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_attention_bwd_routes_by_length(cuda_device):
    """bf16 up to 160 tokens either way takes the fused kernel, past them
    the long route (counted in ``launches_long`` too), each equal to the
    plain version; fp32 its own kernels. The fused kernel's shared memory
    is the one ``bwd_route`` reckons with."""
    from signal_tpu_torch.ops import flash_attention as fa

    lib = fa._load("attention_bwd")
    for Lq, Lk, hd in ((129, 129, 64), (160, 160, 128), (1, 160, 8), (144, 145, 24)):
        assert lib.attention_bwd_smem_bytes(fa.BWD_ROUTES["fused"], Lq, Lk, hd) == \
            fa.bwd_fused_smem_bytes(Lq, Lk, hd)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    for Lq, Lk, dtype, long_route in ((160, 160, torch.bfloat16, 0), (161, 161, torch.bfloat16, 1),
                                      (160, 161, torch.bfloat16, 1), (161, 3, torch.bfloat16, 1),
                                      (200, 200, torch.float32, 0)):
        q, g = (torch.randn(2, Lq, 256, device=cuda_device, generator=gen).to(dtype) for _ in "qg")
        k, v = (torch.randn(2, Lk, 256, device=cuda_device, generator=gen).to(dtype) for _ in "kv")
        before = (fa.attention_bwd_cuda.launches, fa.attention_bwd_cuda.launches_long,
                  fa.attention_bwd_cuda.launches_fp32)
        got = fa.attention_bwd_cuda(q, k, v, g, 2)
        torch.cuda.synchronize()
        assert (fa.attention_bwd_cuda.launches - before[0],
                fa.attention_bwd_cuda.launches_long - before[1],
                fa.attention_bwd_cuda.launches_fp32 - before[2]) == \
            (1, long_route, dtype == torch.float32), (Lq, Lk)
        want = fa.flash_attention_bwd_reference(q, k, v, g, 2)
        tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=8e-3, rtol=1e-2)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                       err_msg=f"{name} {Lq}x{Lk}", **tol)


def test_attention_bwd_long_route_repeats_to_the_bit(cuda_device):
    """The long route sums dQ over a head's key blocks in a fixed order
    (rank order through distributed shared memory, no atomics): two
    launches on the same inputs give the same bits."""
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, g = (torch.randn(4, 211, 768, device=cuda_device, generator=gen).bfloat16()
                  for _ in "qkvg")
    before = attention_bwd_cuda.launches_long
    first = attention_bwd_cuda(q, k, v, g, 12)
    second = attention_bwd_cuda(q, k, v, g, 12)
    torch.cuda.synchronize()
    assert attention_bwd_cuda.launches_long == before + 2
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("B", [192, 3])
def test_fp32_kernels_repeat_to_the_bit(cuda_device, B):
    """The fp32 kernels give every output to one warp and sum in one fixed
    order: two launches at the flagship step's [192, 129, 768] and at a
    pipeline microbatch's few heads give the same bits, both directions."""
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, g = (torch.randn(B, 129, 768, device=cuda_device, generator=gen) for _ in "qkvg")
    assert torch.equal(attention_fwd_cuda(q, k, v, 12), attention_fwd_cuda(q, k, v, 12))
    first = attention_bwd_cuda(q, k, v, g, 12)
    second = attention_bwd_cuda(q, k, v, g, 12)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_fp32_kernels_spill_nothing_the_backward_on_the_tensor_cores(cuda_device):
    """Every instance of the fp32 kernels spills nothing: the forward's at
    hd <= 64 and <= 128, the backward's rows kernel at both, its cols
    kernel with dV's sums chained or fresh at hd <= 64 and by halves of the
    head dim past it. The backward's hold tensor-core instructions
    (3xTF32), the forward's none (it runs on the CUDA cores, exact to
    fp32)."""
    from signal_tpu_torch.ops import _build

    try:
        _build.cuda_tool("cuobjdump")
    except RuntimeError:
        pytest.skip("needs cuobjdump")
    for name, kernels, tensor_cores, instances in (
            ("attention_fwd", ("fwd_fp32_kernel",), False, 2),
            ("attention_bwd", ("rows_tf32_kernel", "cols_tf32_kernel"), True, 5)):
        hmma = {fn: n for fn, n in _build.hmma_counts(name).items()
                if any(k in fn for k in kernels)}
        report = {fn: r for fn, r in _build.ptxas_report(name).items()
                  if any(k in fn for k in kernels)}
        assert len(report) == instances, (name, report)
        assert hmma.keys() <= report.keys(), (name, report, hmma)
        if tensor_cores:
            assert hmma.keys() == report.keys() and all(hmma.values()), (name, hmma)
        else:
            assert not any(hmma.values()), (name, hmma)
        for fn, r in report.items():
            assert r["spill_stores"] == r["spill_loads"] == 0, (fn, r)


def test_bf16_kernels_run_on_the_tensor_cores_without_spills(cuda_device):
    """Each library's bf16 kernels hold tensor-core instructions (HMMA, or
    the long route's warpgroup HGMMA, in ``cuobjdump -sass``) and spill
    nothing (``nvcc -Xptxas -v``): the
    forward's one-pass kernel and its long-route kernel (each of their
    instances), the backward's fused kernel (each of its instances) and
    its long route's two."""
    from signal_tpu_torch.ops import _build

    try:
        _build.cuda_tool("cuobjdump")
    except RuntimeError:
        pytest.skip("needs cuobjdump")
    bf16_kernels = ("mma_kernel", "onepass_kernel", "fwd_long_kernel", "fused_kernel")
    for name in ("attention_fwd", "attention_bwd"):
        hmma = {fn: n for fn, n in _build.hmma_counts(name).items()
                if any(k in fn for k in bf16_kernels)}
        assert hmma and all(hmma.values()), (name, hmma)
        if name == "attention_fwd":
            assert sum("onepass_kernel" in fn for fn in hmma) == 4, hmma
            assert sum("fwd_long_kernel" in fn for fn in hmma) == 2, hmma
        else:
            assert sum("fused_kernel" in fn for fn in hmma) == 4, hmma
        report = {fn: r for fn, r in _build.ptxas_report(name).items()
                  if any(k in fn for k in bf16_kernels)}
        assert report.keys() == hmma.keys(), (name, report, hmma)
        for fn, r in report.items():
            assert r["spill_stores"] == r["spill_loads"] == 0, (fn, r)


def test_flash_attention_gradients_go_through_both_kernels(cuda_device):
    from signal_tpu_torch.ops.flash_attention import (
        attention_bwd_cuda,
        attention_fwd_cuda,
        flash_attention,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(4, 129, 256, device=cuda_device, generator=gen, requires_grad=True)
               for _ in "qkv")
    fwd, bwd = attention_fwd_cuda.launches, attention_bwd_cuda.launches
    out = flash_attention(q, k, v, num_heads=4, compute_dtype=torch.float32)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    assert attention_fwd_cuda.launches == fwd + 1 and attention_bwd_cuda.launches == bwd + 1
    from signal_tpu_torch.ops.attention import _attention_core

    want = torch.autograd.grad((_attention_core(q, k, v, 4, torch.float32) ** 2).sum(),
                               (q, k, v))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=5e-4, rtol=1e-3)


def test_linear_backward_runs_on_the_card(cuda_device):
    """The bf16 product has a backward on the card (``aten::mm.dtype`` has
    none): gradients with respect to x and the weight, against the fp32
    product's."""
    from signal_tpu_torch.ops.attention import linear

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randn(96, 64, device=cuda_device, generator=gen, requires_grad=True)
    x = torch.randn(5, 7, 64, device=cuda_device, generator=gen, requires_grad=True)
    y = linear(w, None, x, torch.bfloat16)
    assert y.dtype == torch.float32
    gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
    fx, fw = torch.autograd.grad(linear(w, None, x, torch.float32).square().sum(), (x, w))
    for a, b in ((gx, fx), (gw, fw)):
        cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0)
        assert cos > 0.999, cos


@pytest.mark.parametrize("dtype,tol", [(torch.float32, dict(atol=1e-5, rtol=1e-5)),
                                       (torch.bfloat16, dict(atol=1e-2, rtol=0))])
def test_masked_core_on_the_card_equals_the_cpu(cuda_device, dtype, tol):
    """CLIP's causal text attention (the eager core with an additive mask)
    on the card against the CPU, at the text tower's shape (77 tokens, 8
    heads of 64); ``mha`` with ``use_flash`` and a mask launches no kernel.
    fp32: summation order; bf16: one rounding of P apart."""
    from signal_tpu_torch.models.text_encoder import causal_mask
    from signal_tpu_torch.ops.attention import MultiheadAttentionParams, _attention_core, mha, \
        true_fp32
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda

    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(16, 77, 512, generator=gen) for _ in range(3))
    want = _attention_core(q, k, v, 8, dtype, mask=causal_mask(77))
    with true_fp32():
        got = _attention_core(*(t.to(cuda_device) for t in (q, k, v)), 8, dtype,
                              mask=causal_mask(77, device=cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **tol)
    attn = MultiheadAttentionParams(512)
    attn.reset_parameters(gen)
    before = attention_fwd_cuda.launches
    with torch.no_grad():
        out = mha(attn.to(cuda_device), q.to(cuda_device), num_heads=8, compute_dtype=dtype,
                  use_flash=True, mask=causal_mask(77, device=cuda_device))
    torch.cuda.synchronize()
    assert attention_fwd_cuda.launches == before and bool(torch.isfinite(out).all())


def _integer_features(seed, n, dim):
    """Small integers: every distance is exact in fp32 on the card and on
    the CPU, so both rank the same (ties by index) and only summation
    order separates their re-ranked distances."""
    return np.random.default_rng(seed).integers(-3, 4, (n, dim)).astype(np.float32)


def test_reranking_on_the_card_equals_the_cpu(cuda_device):
    from signal_tpu_torch.reranking import re_ranking

    feats = torch.from_numpy(_integer_features(4, 320, 64))       # 40 query + 280 gallery
    want = re_ranking(feats[:40], feats[40:], k1=20, k2=6, lambda_value=0.3)
    got = re_ranking(feats[:40].to(cuda_device), feats[40:].to(cuda_device), k1=20, k2=6,
                     lambda_value=0.3)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5, rtol=1e-4)


def test_accumulation_on_the_card_equals_one_step_on_half(cuda_device):
    """ACCUM_ITER = 2 on [h; h] equals ACCUM_ITER = 1 on h (fp32, SGD,
    center loss, both kernels): each microbatch is h. Each microbatch
    launches the forward kernel twice per block (remat) and the backward
    once."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.engine.train import init_centers, make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    spec = sm.ModelSpec(num_classes=5, camera_num=3, width=128, layers=2, num_heads=4,
                        feat_dim=64, h=4, w=4, topk=3, compute_dtype="float32", use_flash=True)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randint(0, 256, (8, 3, 3, 64, 64), dtype=torch.uint8, device=cuda_device,
                      generator=gen)
    pids = torch.tensor([0, 0, 3, 3, 1, 1, 4, 4], device=cuda_device)
    cams = torch.randint(0, 3, (8,), device=cuda_device, generator=gen)
    results = []
    dup = tuple(torch.cat([t, t]) for t in (x, pids, cams))
    for accum, batch in ((1, (x, pids, cams)), (2, dup)):
        cfg = load_config("configs/synthetic/smoke.yml", [
            "SOLVER.OPTIMIZER_NAME", "SGD", "SOLVER.ACCUM_ITER", str(accum),
            "MODEL.METRIC_LOSS_TYPE", "triplet_center", "DATALOADER.NUM_INSTANCE", "2",
            "INPUT.SIZE_TRAIN", "[64, 64]", "MODEL.TOPK", "3"])
        model = sm.init_signal(spec, seed=0).to(cuda_device)
        optimizer = make_optimizer(model, cfg)
        set_lr(optimizer, *schedule_coeffs(cfg, 1))
        centers = init_centers(cfg, spec, 5, cuda_device)
        step = make_train_step(model, cfg, 5, optimizer, centers=centers)
        fwd, bwd = attention_fwd_cuda.launches, attention_bwd_cuda.launches
        loss, _ = step(*batch)
        torch.cuda.synchronize()
        assert (attention_fwd_cuda.launches - fwd, attention_bwd_cuda.launches - bwd) == \
            (2 * spec.layers * accum, spec.layers * accum)
        results.append((loss.item(), dict(model.named_parameters()), centers))
    (l1, p1, c1), (l2, p2, c2) = results
    assert l2 == pytest.approx(l1, rel=1e-5)
    for name, p in p1.items():
        torch.testing.assert_close(p2[name], p, rtol=1e-4, atol=1e-6, msg=name)
    torch.testing.assert_close(c2, c1, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,opts", [
    ("prompt", dict(prompt=True, adapter=True)),
    ("moe", dict(moe_experts=4, moe_topk=2)),
    ("frozen", dict(frozen=True)),
    ("stride12", dict(h=21, w=10, stride_size=12)),
    ("imagenet", dict(backbone="imagenet", feat_dim=128, img_h=64, img_w=64)),
    ("imagenet_stride12", dict(backbone="imagenet", feat_dim=128, h=21, w=10,
                               stride_size=12, img_h=256, img_w=124)),
    ("t2t", dict(backbone="t2t", feat_dim=128, img_h=64, img_w=64, mlp_ratio=3.0)),
])
def test_variant_train_step_goes_through_both_kernels(cuda_device, name, opts):
    """One fp32 train step's loss and gradients of a small variant tower on
    the card, kernel path against plain-attention path, with its launches:
    2 forward and 1 backward per block and stream (the prompted tower runs
    three streams; STRIDE_SIZE 12 runs 211 tokens, the backward's long route
    in bf16 — here fp32), the ImageNet ViT's at both strides, and T2T's
    body. T2T's linear kernels are taken at 5× their init σ, as in the CPU
    parity tests: at σ 0.02 its tower maps every input to nearly one
    feature, and the BNNecks' differences are fp32 rounding."""
    import dataclasses

    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.attention import true_fp32
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda, attention_fwd_cuda

    spec = sm.ModelSpec(**{**dict(num_classes=5, camera_num=3, width=128, layers=2,
                                  num_heads=2, feat_dim=64, h=4, w=4, topk=3,
                                  compute_dtype="float32"), **opts})
    H = (spec.h - 1) * spec.stride_size + 16
    W = (spec.w - 1) * spec.stride_size + 16
    model = sm.init_signal(spec, seed=0).to(cuda_device)
    if spec.backbone == "t2t":
        with torch.no_grad():
            for m in model.base.modules():
                if isinstance(m, torch.nn.Linear):
                    m.weight.mul_(5.0)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(4, 3, 3, H, W, device=cuda_device, generator=gen)
    cams = torch.tensor([0, 1, 2, 0], device=cuda_device)
    params = [p for p in model.parameters() if p.requires_grad]
    runs = []
    for use_flash in (True, False):
        model.spec = dataclasses.replace(spec, use_flash=use_flash)
        fwd, bwd = attention_fwd_cuda.launches, attention_bwd_cuda.launches
        with true_fp32():
            out = sm.forward_train(model, x, cams)
            loss = sum(s.logsumexp(-1).mean() for s in out["scores"]) + out["gam"] + out["lam"]
            if out["moe_aux"] is not None:
                loss = loss + out["moe_aux"]
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        n = (3 if spec.prompt else 1) * spec.layers
        launched = (attention_fwd_cuda.launches - fwd, attention_bwd_cuda.launches - bwd)
        assert launched == ((2 * n, n) if use_flash else (0, 0)), (name, launched)
        runs.append((loss.item(), grads))
    (loss_k, g_k), (loss_p, g_p) = runs
    assert loss_k == pytest.approx(loss_p, rel=1e-5)
    for a, b in zip(g_k, g_p):
        if b is not None and b.norm() > 1e-6:
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * b.abs().max().item())


def test_spans_land_on_the_cuda_timelines_clock(cuda_device, tmp_path):
    """On a profile of CUDA activity alone (no host operators), a span
    around ``torch.cuda.synchronize()``, mapped with the trace's
    ``baseTimeNanoseconds``, contains the timeline's one
    ``cudaDeviceSynchronize`` of that moment. The call's ``tid`` is the
    thread that made every CUDA call here: a CUDA-only profile names a
    thread by the profiler's own id until the process has profiled the
    host's activity, so it need not be the span's native id."""
    import json

    from signal_tpu_torch.utils import profiler

    x = torch.randn(2048, 2048, device=cuda_device)
    x @ x
    torch.cuda.synchronize()
    path = str(tmp_path / "t.json")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof, \
            profiler.recording() as spans:
        for _ in range(4):
            x = x @ x
        with profiler.span("sync"):
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    (sync,) = profiler.chrome_events(spans, doc["baseTimeNanoseconds"])
    calls = [e for e in doc["traceEvents"] if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    syncs = [e for e in calls if e["name"] == "cudaDeviceSynchronize"]
    inside = [e for e in syncs if sync["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= sync["ts"] + sync["dur"]]
    # each call's start and end against the span's, µs
    seen = [(e["tid"], e["ts"] - sync["ts"], e["ts"] + e["dur"] - sync["ts"] - sync["dur"])
            for e in syncs]
    assert len(inside) == 1, (sync["tid"], sync["dur"], seen)
    assert {e["tid"] for e in calls} == {inside[0]["tid"]}


def _epilogue_inputs(device, rows, cols, n):
    """fp32 products (n of them) with the values a tower writes and a few
    specials at the front (signed zeros, exp's overflow and underflow in
    QuickGELU, subnormals), their fp32 bias, and a bf16 residual stream."""
    gen = torch.Generator(device=device).manual_seed(rows * 7 + cols)
    accs = [3 * torch.randn(rows, cols, device=device, generator=gen) for _ in range(n)]
    specials = torch.tensor([0.0, -0.0, 1.00390625, -2.0078125, 60.0, -60.0, 95.0, -95.0,
                             1e-39, -1e-39, 3.0, -3.0], device=device)
    for a in accs:
        a.view(-1)[:specials.numel()] = specials[:a.numel()]
    bias = torch.randn(n * cols, device=device, generator=gen)
    x = (4 * torch.randn(rows, cols, device=device, generator=gen)).to(torch.bfloat16)
    return accs, bias, x


def _bits(t):
    return t.view(torch.int16)


# each epilogue at its gallery shape (3 · 128 rows of 129 tokens: q, k, v,
# out-proj and c_proj at 768 columns, fc at 3072) and at ragged ones: one
# row, a width of 8 or 24 (fewer column groups than a block), rows and
# column groups across a block's edges
_EPILOGUE_SHAPES = [("bias_cast", 49536, 768), ("bias_gelu", 49536, 3072),
                    ("bias_residual", 49536, 768)] + [
    (name, rows, cols) for name in ("bias_cast", "bias_gelu", "bias_residual")
    for rows, cols in ((1, 8), (37, 24), (1001, 1032))]


@pytest.mark.parametrize("name,rows,cols", _EPILOGUE_SHAPES)
def test_epilogue_kernels_match_the_aten_chain(cuda_device, name, rows, cols):
    """Each epilogue kernel against the ATen chain it replaces, on the card,
    to the bit (signed zeros included), and its launch counted."""
    from signal_tpu_torch.ops import epilogue

    n = 3 if name == "bias_cast" else 1
    accs, bias, x = _epilogue_inputs(cuda_device, rows, cols, n)
    launcher = getattr(epilogue, f"{name}_cuda")
    before = launcher.launches
    with torch.inference_mode():
        if name == "bias_cast":
            got = torch.ops.signal_tpu_torch.bias_cast(*accs, bias)
            want = [(a + b.float()).to(torch.bfloat16) for a, b in zip(accs, bias.chunk(3))]
        elif name == "bias_gelu":
            got = [torch.ops.signal_tpu_torch.bias_gelu(accs[0], bias)]
            from signal_tpu_torch.ops.attention import quick_gelu

            want = [quick_gelu((accs[0] + bias).to(torch.bfloat16))]
        else:
            got = [torch.ops.signal_tpu_torch.bias_residual(accs[0], bias, x)]
            want = [x + (accs[0] + bias).to(torch.bfloat16)]
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.is_contiguous() and g.data_ptr() % 16 == 0
        bad = (_bits(g) != _bits(w)).nonzero()
        assert bad.numel() == 0, (len(bad), bad[:4].tolist())


def test_bias_gelu_matches_the_aten_chain_on_every_bf16_value(cuda_device):
    """QuickGELU's input is a bf16 value, so bias_gelu's arithmetic (its
    reciprocal's fast route included) meets at most 2^16 cases: every bf16
    bit pattern but the NaNs, each once, to the bit."""
    from signal_tpu_torch.ops.attention import quick_gelu

    values = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda_device)
    values = values.to(torch.int16).view(torch.bfloat16)
    values = values[~values.isnan()].float()
    acc = torch.cat([values, values.new_zeros(-values.numel() % 1024)]).reshape(-1, 1024)
    bias = torch.zeros(1024, device=cuda_device)
    with torch.inference_mode():
        got = torch.ops.signal_tpu_torch.bias_gelu(acc, bias)
        want = quick_gelu((acc + bias).to(torch.bfloat16))
    torch.cuda.synchronize()
    bad = (_bits(got) != _bits(want)).nonzero()
    assert bad.numel() == 0, (len(bad), [acc[i, j].item() for i, j in bad[:4].tolist()])


def test_epilogue_kernels_refuse_what_they_cannot_take(cuda_device):
    from signal_tpu_torch.ops import epilogue

    acc = torch.zeros(4, 16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        epilogue.bias_gelu_cuda(torch.zeros(4, 12, device=cuda_device),
                                torch.zeros(12, device=cuda_device))
    with pytest.raises(ValueError, match="fp32 products"):
        epilogue.bias_gelu_cuda(acc.to(torch.bfloat16), torch.zeros(16, device=cuda_device))
    with pytest.raises(ValueError, match="bias"):
        epilogue.bias_cast_cuda(acc, acc, acc, torch.zeros(16, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        epilogue.bias_residual_cuda(acc, torch.zeros(16, device=cuda_device),
                                    torch.zeros(16, 4, device=cuda_device,
                                                dtype=torch.bfloat16).t())
    with pytest.raises(ValueError, match="contiguous"):
        epilogue.bias_gelu_cuda(acc, torch.zeros(32, device=cuda_device)[::2])
    with pytest.raises(RuntimeError, match="no backward"):
        epilogue.bias_gelu_cuda(acc, torch.zeros(16, device=cuda_device, requires_grad=True))


def _epilogue_launches():
    from signal_tpu_torch.ops import epilogue

    return (epilogue.bias_cast_cuda.launches + epilogue.bias_gelu_cuda.launches
            + epilogue.bias_residual_cuda.launches)


def test_eval_forward_launches_the_epilogues_and_keeps_the_bits(cuda_device):
    """The flagship tower's eval forward (bf16, 12 blocks, the attention
    kernel) launches the epilogue kernels 4 times a block, 48 in all, and
    gives the bits of the same forward under grad mode (the ATen chain),
    which launches none."""
    from signal_tpu_torch.models import signal_model as sm

    spec = sm.ModelSpec(num_classes=171, camera_num=4, use_flash=True)
    model = sm.init_signal(spec, seed=0).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    imgs = torch.randn(2, 3, 3, 256, 128, device=cuda_device, generator=gen)
    cams = torch.tensor([0, 3], device=cuda_device)
    before = _epilogue_launches()
    with torch.inference_mode():
        got = sm.forward_eval(model, imgs, cams)
    torch.cuda.synchronize()
    assert _epilogue_launches() - before == 4 * spec.layers == 48
    before = _epilogue_launches()
    with torch.enable_grad():
        want = sm.forward_eval(model, imgs, cams)
    torch.cuda.synchronize()
    assert _epilogue_launches() == before and want.requires_grad
    assert torch.equal(got, want.detach())


def test_train_step_launches_no_epilogue(cuda_device):
    """A bf16 train step (grad mode on, remat) keeps the ATen chain: no
    epilogue launch, the attention kernels launched."""
    from signal_tpu_torch.config import load_config
    from signal_tpu_torch.engine.train import make_train_step
    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_bwd_cuda
    from signal_tpu_torch.solver import make_optimizer, schedule_coeffs, set_lr

    spec = sm.ModelSpec(num_classes=5, camera_num=3, width=128, layers=2, num_heads=4,
                        feat_dim=64, h=4, w=4, topk=3, use_flash=True)
    cfg = load_config("configs/synthetic/smoke.yml", [
        "DATALOADER.NUM_INSTANCE", "2", "INPUT.SIZE_TRAIN", "[64, 64]", "MODEL.TOPK", "3"])
    model = sm.init_signal(spec, seed=0).to(cuda_device)
    optimizer = make_optimizer(model, cfg)
    set_lr(optimizer, *schedule_coeffs(cfg, 1))
    step = make_train_step(model, cfg, 5, optimizer)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randint(0, 256, (8, 3, 3, 64, 64), dtype=torch.uint8, device=cuda_device,
                      generator=gen)
    pids = torch.tensor([0, 0, 3, 3, 1, 1, 4, 4], device=cuda_device)
    cams = torch.randint(0, 3, (8,), device=cuda_device, generator=gen)
    before, bwd = _epilogue_launches(), attention_bwd_cuda.launches
    loss, _ = step(x, pids, cams)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert _epilogue_launches() == before and attention_bwd_cuda.launches == bwd + spec.layers


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_t2t_eval_forward_takes_the_kernels(cuda_device, dtype):
    """T2T-ViT-t-14 at its widths (256×128, 14 blocks of 6 heads at 129
    tokens): an eval forward launches the attention kernel once a block
    and the token attention operator once a token transformer, each call
    the token attention kernel (two launches a forward), and its
    outputs keep to the plain path's by phase 15's rules: in bf16 the
    tower's class and patch tokens by cosine > 0.99, in fp32 the features
    by atol 1e-3 + rtol 1e-3. The tokens-to-token module's Linear weights
    are taken at 5× their init σ, as phase 15 takes them: at σ 0.02 its
    output is a tenth of the sinusoid table's and every input maps to
    nearly one feature."""
    import dataclasses

    from signal_tpu_torch.models import signal_model as sm
    from signal_tpu_torch.ops.flash_attention import attention_fwd_cuda
    from signal_tpu_torch.ops.token_attention import token_attention, token_attention_cuda

    spec = sm.ModelSpec(num_classes=171, camera_num=4, backbone="t2t", width=384, layers=14,
                        num_heads=6, feat_dim=384, mlp_ratio=3.0, img_h=256, img_w=128,
                        compute_dtype=dtype)
    model = sm.init_signal(spec, seed=0).to(cuda_device)
    with torch.no_grad():
        for m in model.base.tokens_to_token.modules():
            if isinstance(m, torch.nn.Linear):
                m.weight.mul_(5.0)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    imgs = torch.randn(4, 3, 3, 256, 128, device=cuda_device, generator=gen)
    cams = torch.tensor([0, 3, 1, 2], device=cuda_device)
    out = {}
    for use_flash in (True, False):
        model.spec = dataclasses.replace(spec, use_flash=use_flash)
        fwd, calls = attention_fwd_cuda.launches, token_attention.calls
        token = token_attention_cuda.launches
        with torch.inference_mode():
            patches, cls, _ = sm._encode(model, imgs, cams)
            feats = sm.forward_eval(model, imgs, cams)
        torch.cuda.synchronize()
        # each token transformer's call launches the token attention
        # kernel, whatever the body takes: no call falls back to the eager core
        assert (attention_fwd_cuda.launches - fwd, token_attention.calls - calls,
                token_attention_cuda.launches - token) == ((28 if use_flash else 0), 4, 4)
        out[use_flash] = (patches, cls, feats)
    (p_k, c_k, f_k), (p_p, c_p, f_p) = out[True], out[False]
    if dtype == "float32":
        torch.testing.assert_close(f_k, f_p, atol=1e-3, rtol=1e-3)
    else:
        cos = torch.nn.functional.cosine_similarity
        assert cos(c_k.flatten(0, 1), c_p.flatten(0, 1), dim=-1).min() > 0.99
        assert cos(p_k.flatten(0, 2), p_p.flatten(0, 2), dim=-1).min() > 0.99


# T2T's token attention kernel (csrc/token_attention.cu, behind
# signal_tpu_torch::token_attention on the card): the gallery's lengths at
# 4 rows, ragged lengths on each side of a 64-key tile and a 128-row block
# (77, 129, 2047), one query against many keys and many queries against
# one key
_TOKEN_SHAPES = [(4, 2048, 2048), (4, 512, 512), (2, 77, 77), (2, 2047, 2047), (2, 1, 2047),
                 (2, 129, 65), (2, 200, 1)]


def _token_qkv(B, Lq, Lk, scale, device, seed=0, grad=False):
    """q, k, v as ``models/t2t.token_transformer`` hands them over: the
    ``.chunk(3, -1)`` views of [B, L, 192] qkv products (row stride 192),
    one product where Lq == Lk; q scaled so that the logits spread with a
    standard deviation of about 2, as in the T2T cell. → (products, views)"""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(B, Lq, 192, device=device, generator=gen)
    a[..., :64] *= 2.0 / (8.0 * scale)
    b = a if Lk == Lq else torch.randn(B, Lk, 192, device=device, generator=gen)
    prods = [t.requires_grad_(grad) for t in ((a,) if b is a else (a, b))]
    return prods, (prods[0][..., :64], prods[-1][..., 64:128], prods[-1][..., 128:])


def _row_gap(x, ref):
    """Largest relative L2 gap of a row of x against ref (float64)."""
    return ((x.double() - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def _tf32(x):
    """x rounded to TF32 (10 bits of mantissa, to nearest, ties away), as
    float64."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32).double()


def _tf32_attention(q, k, v, s):
    """The eager core with TF32 products: each product's operands rounded
    to TF32, the sums in float64 (cuBLAS may take no TF32 path at small
    shapes, so its TF32 mode is no yardstick there)."""
    p = torch.softmax(_tf32(q * s) @ _tf32(k).transpose(1, 2), dim=-1)
    return _tf32(p) @ _tf32(v)


@pytest.mark.parametrize("B,Lq,Lk", _TOKEN_SHAPES)
def test_token_attention_kernel_is_fp32_accurate(cuda_device, B, Lq, Lk):
    """The kernel takes the strided views as they lie, one launch a call,
    the same bits twice; against a float64 eager core each row is within
    2e-6 (relative L2; the kernel read at most 1.3e-6, the fp32 eager core
    3.2e-6 at 2,048 keys), and at least 20× closer than TF32 products, the
    precision below fp32."""
    from signal_tpu_torch.ops.token_attention import eager_core, token_attention, \
        token_attention_cuda

    s = 147 ** -0.5
    _, (q, k, v) = _token_qkv(B, Lq, Lk, s, cuda_device)
    before = token_attention_cuda.launches
    with torch.no_grad():
        out, again = token_attention(q, k, v, s), token_attention(q, k, v, s)
        torch.cuda.synchronize()
        assert token_attention_cuda.launches - before == 2
        assert out.shape == (B, Lq, 64) and torch.equal(out, again)
        ref = eager_core(q.double(), k.double(), v.double(), s)
        gap, tf32_gap = _row_gap(out, ref), _row_gap(_tf32_attention(q, k, v, s), ref)
    assert gap <= 2e-6 and 20 * gap <= tf32_gap, (gap, tf32_gap)


def test_token_attention_kernel_gradients_are_the_eager_ones(cuda_device):
    """Autograd through the operator on the card (the kernel's forward, the
    eager recomputing backward) gives the eager expression's output and
    gradients, to the tolerances the CPU test holds the operator to."""
    from signal_tpu_torch.ops.attention import true_fp32
    from signal_tpu_torch.ops.token_attention import token_attention, token_attention_cuda

    s = 576 ** -0.5
    grads = []
    for kernel in (True, False):
        prods, (q, k, v) = _token_qkv(2, 300, 300, s, cuda_device, seed=3, grad=True)
        before = token_attention_cuda.launches
        if kernel:
            out = token_attention(q, k, v, s)
        else:
            with true_fp32():
                out = torch.softmax((q * s) @ k.transpose(1, 2), dim=-1) @ v
        assert token_attention_cuda.launches - before == int(kernel)
        g = torch.randn(out.shape, device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(4))
        grads.append((out.detach(), *torch.autograd.grad(out, prods, g)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["head_dim_32", "bfloat16", "float64", "row_stride_66"])
def test_token_attention_on_the_card_launches_the_kernel_or_raises(cuda_device, case):
    """On the card the operator has one route: inputs the kernel cannot
    take (another head dim, other dtypes) raise with no launch; fp32 at
    head dim 64 in a row stride TMA cannot address (66 floats) is read
    from a contiguous copy, one launch, as fp32-accurate as the views."""
    from signal_tpu_torch.ops.token_attention import eager_core, token_attention, \
        token_attention_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    dtype = {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(case, torch.float32)
    width = {"head_dim_32": 96, "row_stride_66": 198}.get(case, 192)
    x = torch.randn(2, 50, width, device=cuda_device, generator=gen).to(dtype)
    q, k, v = x[..., :width - 6].chunk(3, dim=-1) if case == "row_stride_66" else \
        x.chunk(3, dim=-1)
    before = token_attention_cuda.launches
    with torch.no_grad():
        if case != "row_stride_66":
            with pytest.raises(ValueError, match="fp32 q"):
                token_attention(q, k, v, 0.1)
            assert token_attention_cuda.launches == before
            return
        out = token_attention(q, k, v, 0.1)
        torch.cuda.synchronize()
        ref = eager_core(q.double(), k.double(), v.double(), 0.1)
    assert token_attention_cuda.launches - before == 1
    assert _row_gap(out, ref) <= 2e-6


def test_token_attention_kernel_spills_nothing_on_the_tensor_cores(cuda_device):
    """The token attention kernel runs its products on the tensor cores
    (warpgroup HGMMA in ``cuobjdump -sass``) and spills nothing."""
    from signal_tpu_torch.ops import _build

    try:
        _build.cuda_tool("cuobjdump")
    except RuntimeError:
        pytest.skip("needs cuobjdump")
    _build.build(["token_attention"])
    report = _build.ptxas_report("token_attention")
    hmma = _build.hmma_counts("token_attention")
    assert len(report) == 1 and hmma.keys() == report.keys(), (report, hmma)
    for fn, r in report.items():
        assert hmma[fn] > 0 and r["spill_stores"] == r["spill_loads"] == 0, (fn, r, hmma)
