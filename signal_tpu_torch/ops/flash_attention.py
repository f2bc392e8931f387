"""Fused attention, forward and backward (port of
`signal_tpu/ops/flash_attention.py`).

``flash_attention`` is the post-projection attention the ViT blocks call
through ``mha(use_flash=True)``. It casts q, k, v to the compute dtype and
calls the registered operator ``torch.ops.signal_tpu_torch.attention_fwd``
(:func:`attention_fwd`), whose autograd formula is the port of the JAX
``custom_vjp``:

* on CPU tensors the forward is :func:`flash_attention_reference` and the
  backward :func:`flash_attention_bwd_reference`, the plain PyTorch
  versions of what the TPU kernels compute;
* on CUDA tensors the forward launches ``csrc/attention_fwd.cu``
  (:func:`attention_fwd_cuda`) and the backward ``csrc/attention_bwd.cu``
  (:func:`attention_bwd_cuda`), or raises. There is no fallback from one
  to the other.

Training, eval and ``torch.export`` take this one route to the kernel.
The operator has a fake implementation for tracing (a ctypes call cannot
be traced), and it is what ``torch.export`` keeps in a serving graph
(``signal_tpu_torch/serving.py``).

The kernels replace ``_attn_kernel`` and ``_attn_bwd_kernel``. At the
ViT-B shape ([3B, 129, 768], 12 heads of 64, bf16) both do tens of FLOP
per byte moved, against the card's ~295 FLOP/B ridge, so their floor is
device memory. What holds them above it is their on-chip work, and their
bf16 paths run it on the tensor cores (``mma.sync``, bf16 in, fp32
accumulation), at the TPU kernels' rounding points. Their fp32 paths are
fp32-accurate: the forward runs on the CUDA cores, exact to fp32 (a
register-tiled kernel, one fmaf chain an output); the backward's products
run on the tensor cores as 3xTF32 (a tf32 high part and a remainder of
each operand, three ``mma.sync`` a product, about 21 bits kept, as
PyTorch's own fp32 SDPA does). TF32 itself is not turned on. Both stream
the keys (or the queries) through a ring of chunks: the fp32 backward takes
any length, the fp32 forward as many keys as one warp's rows of logits
fit in shared memory (3264 at hd <= 64, 2944 at hd <= 128). Both keep
everything of size [Lq, Lk] on chip and read the heads by stride from
[B, L, D], so no transpose copies are made.

The bf16 forward has two routes, chosen here from the keys
(:func:`fwd_route`): up to :data:`FWD_ONE_PASS_MAX_KEYS` (256, every
shipped shape) the one-pass kernel, in which a warp holds a query tile's
whole key row of logits in registers, so each logit and each exponential
is computed once, and a block (or a thread-block cluster of up to 8, when
the heads are too few to fill the card) brings each head's K and V on
chip once with TMA; past 256 keys the long-route kernel, at any length
(K and V streamed through a ring of chunks by TMA and swept twice: the
rows' statistics, then the exact P and P·V), counted in
``attention_fwd_cuda.launches_long`` as well. A shape whose route does
not fit in shared memory raises.

The bf16 backward routes here too (:func:`bwd_route`): while Lq and Lk are
at most :data:`BWD_FUSED_MAX_LEN` (160, every shipped shape at 129
tokens) and the head fits its shared memory, the fused kernel: a block (or
a cluster, for few heads) brings one head's Q, K, V and G on chip by TMA
and runs two phases on them, query tiles (dQ) then key tiles (dK, dV),
three blocks an SM at 129 tokens; past 160 tokens the long route (a
row-statistics kernel, then a key-parallel cluster kernel, up to 1024
keys), counted in ``attention_bwd_cuda.launches_long``. The sources say
more. Mesh and tensor-parallel routing (`:263-281` of the JAX module) live
in ``ops/attention.sharded_attention``.
"""

from __future__ import annotations

import ctypes
import math

import torch

# the kernels' limits: 16-byte vector loads of a head's columns (hd % 8 ==
# 0), and hd <= 128, at which the bf16 backward's fused kernel still holds
# Lq = Lk = 160 in shared memory (166,896 B; its long route takes up to
# 1024 keys)
MAX_HEAD_DIM = 128

# the bf16 forward's one-pass kernel keeps a whole key row of logits in a
# warp's registers: up to this many keys; longer rows take the long route
# (``csrc/attention_fwd.cu``'s ``attention_fwd_one_pass_max_keys``)
FWD_ONE_PASS_MAX_KEYS = 256
# the forward's routes, as ``attention_fwd`` in the source numbers them
FWD_ROUTES = {"fp32": 0, "one_pass": 1, "long": 2}


# the bf16 backward's fused kernel holds a query tile's whole key row in
# registers and a head's Q, K, V and G in shared memory: up to this many
# tokens either way; longer ones take the long route
# (``csrc/attention_bwd.cu``'s ``attention_bwd_fused_max_len``)
BWD_FUSED_MAX_LEN = 160
# the backward's routes, as ``attention_bwd`` in the source numbers them
BWD_ROUTES = {"fp32": 0, "fused": 1, "long": 2}
# the most dynamic shared memory a block of an H100 may opt into (227 KB)
SMEM_OPTIN_BYTES = 232448


def fwd_route(dtype: torch.dtype, Lk: int) -> str:
    """The forward kernel a launch takes: ``fp32`` (the CUDA cores), or in
    bf16 ``one_pass`` up to :data:`FWD_ONE_PASS_MAX_KEYS` keys and
    ``long`` (two sweeps over streamed keys, any length) past them."""
    if dtype == torch.float32:
        return "fp32"
    return "one_pass" if Lk <= FWD_ONE_PASS_MAX_KEYS else "long"


def bwd_fused_smem_bytes(Lq: int, Lk: int, hd: int) -> int:
    """Shared memory of one block of the fused backward kernel
    (``fused_smem_bytes`` in the source): Q, G, K and V at 144 rows while
    a warp's register row of 136 keys takes Lk and the rows take Lq, else
    at 160, in 128-byte slabs of 64 bf16 columns (one up to hd 64, two past
    it); each row's three statistics; 4 + 10 barriers (the operands'
    copies, the query tiles' statistics); 1024 bytes to align the slabs."""
    rows = 144 if Lk <= 136 and (Lq + 15) // 16 * 16 <= 144 else 160
    slabs = 1 if (hd + 15) // 16 * 16 <= 64 else 2
    return 1024 + 4 * slabs * rows * 128 + 12 * rows + 8 * 14


def bwd_route(dtype: torch.dtype, Lq: int, Lk: int, hd: int) -> str:
    """The backward kernels a launch takes: ``fp32`` (3xTF32, any length),
    or in bf16 ``fused`` while Lq, Lk <= :data:`BWD_FUSED_MAX_LEN` and the
    head's tiles fit a block's shared memory, else ``long`` (the
    statistics and key-parallel kernels). Every head dim the kernels take
    (<= 128) fits up to 160 tokens (166,896 B at hd 128), so today the
    lengths alone decide."""
    if dtype == torch.float32:
        return "fp32"
    fits = bwd_fused_smem_bytes(Lq, Lk, hd) <= SMEM_OPTIN_BYTES
    return "fused" if max(Lq, Lk) <= BWD_FUSED_MAX_LEN and fits else "long"


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] → fp32 [B, H, L, hd]."""
    B, L, D = t.shape
    return t.reshape(B, L, num_heads, D // num_heads).transpose(1, 2).float()


def _merge(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, L, hd] → [B, L, H·hd] in ``dtype``."""
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd).to(dtype)


def _probs(qh: torch.Tensor, kh: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 softmax of the logits, scaled AFTER the dot (the kernels'
    order, unlike the eager core), row max subtracted, then e / Σe."""
    logits = (qh @ kh.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """What the forward kernel computes, in plain PyTorch. q [B, Lq, D],
    k/v [B, Lk, D], all in the operand dtype → [B, Lq, D] in q's dtype.

    Per head: logits = (q·kᵀ from operand-dtype values, fp32 accumulation)
    × scale, fp32 softmax, P rounded to the operand dtype, P·V accumulated
    in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    probs = _probs(_heads(q, num_heads), _heads(k, num_heads), scale)
    out = probs.to(v.dtype).float() @ _heads(v, num_heads)
    return _merge(out, q.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  g: torch.Tensor, num_heads: int):
    """What the backward kernel computes, in plain PyTorch, at the TPU
    kernel's rounding points (`_attn_bwd_kernel`), not autograd's. q, g
    [B, Lq, D], k/v [B, Lk, D], all in the operand dtype → (dq, dk, dv) in
    that dtype.

    Per head: P in fp32; dV = round(P)ᵀ·g; dP = g·Vᵀ in fp32;
    dS = P∘(dP − rowsum(dP∘P)) from the fp32 P; dQ = (round(dS)·K)·scale,
    dK = (round(dS)ᵀ·Q)·scale; round() is to the operand dtype and every
    product accumulates in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, g))
    p = _probs(qh, kh, scale)
    dv = p.to(v.dtype).float().transpose(-1, -2) @ gh
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsc = ds.to(q.dtype).float()
    dq = (dsc @ kh) * scale
    dk = (dsc.transpose(-1, -2) @ qh) * scale
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def attention64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_heads: int) -> torch.Tensor:
    """softmax(scale q·kᵀ)·v per head in fp64, [B, Lq, D] → fp64: the
    yardstick of the fp32 kernels' error (the plain versions compute in
    fp32). Not on any path of the port; ``chip_smoke.py`` and
    ``scripts/variants_torch_attention.py`` read it."""
    qh, kh, vh = (t.double().unflatten(-1, (num_heads, -1)).transpose(1, 2) for t in (q, k, v))
    p = ((qh @ kh.transpose(-1, -2)) * qh.shape[-1] ** -0.5).softmax(-1)
    return (p @ vh).transpose(1, 2).flatten(2)


def attention_bwd64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                    num_heads: int):
    """(dq, dk, dv) of :func:`attention64` at output gradient g, in fp64."""
    qh, kh, vh, gh = (t.double().unflatten(-1, (num_heads, -1)).transpose(1, 2)
                      for t in (q, k, v, g))
    scale = qh.shape[-1] ** -0.5
    p = ((qh @ kh.transpose(-1, -2)) * scale).softmax(-1)
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    out = ((ds @ kh) * scale, (ds.transpose(-1, -2) @ qh) * scale, p.transpose(-1, -2) @ gh)
    return tuple(t.transpose(1, 2).flatten(2) for t in out)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, num_heads: int, q, *rest) -> int:
    """Raise on anything the kernels do not take; → head dim. ``rest`` is
    k, v (and g for the backward)."""
    k = rest[0]
    tensors = (q, *rest)
    if not (q.is_cuda and all(t.device == q.device for t in rest)):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in rest):
        raise ValueError(f"{name} takes fp32 or bf16 tensors of one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != rest[1].shape:
        raise ValueError(f"want q [B, Lq, D], k = v [B, Lk, D], got "
                         f"{[tuple(t.shape) for t in tensors]}")
    B, Lq, D = q.shape
    if k.shape[0] != B or k.shape[2] != D or Lq < 1 or k.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if len(rest) > 2 and rest[2].shape != q.shape:
        raise ValueError(f"g {tuple(rest[2].shape)} differs from q {tuple(q.shape)}")
    if D % num_heads:
        raise ValueError(f"D={D} is not a multiple of num_heads={num_heads}")
    hd = D // num_heads
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes hd % 8 == 0 and "
                         f"hd <= {MAX_HEAD_DIM}")
    for label, t in zip("qkvg", tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{label} must be contiguous and 16-byte aligned")
    return hd


_libs = {}


def _load(name: str) -> ctypes.CDLL:
    """The built library with its C signatures declared (once: a
    microbatch's launch is bound by this host path)."""
    if name in _libs:
        return _libs[name]
    from signal_tpu_torch.ops._build import load

    lib = load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "attention_fwd":
        lib.attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.attention_fwd_one_pass_max_keys.argtypes = []
        lib.attention_fwd_one_pass_max_keys.restype = i
        if lib.attention_fwd_one_pass_max_keys() != FWD_ONE_PASS_MAX_KEYS:
            raise RuntimeError("csrc/attention_fwd.cu and FWD_ONE_PASS_MAX_KEYS disagree")
    else:
        lib.attention_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      ctypes.c_float, p]
        lib.attention_bwd_stats_floats.argtypes = [i, i, i, i, i]
        lib.attention_bwd_stats_floats.restype = ctypes.c_size_t
        lib.attention_bwd_long_max_keys.argtypes = []
        lib.attention_bwd_long_max_keys.restype = i
        lib.attention_bwd_fused_max_len.argtypes = []
        lib.attention_bwd_fused_max_len.restype = i
        if lib.attention_bwd_fused_max_len() != BWD_FUSED_MAX_LEN:
            raise RuntimeError("csrc/attention_bwd.cu and BWD_FUSED_MAX_LEN disagree")
    getattr(lib, f"{name}_smem_bytes").argtypes = [i, i, i, i]
    getattr(lib, name).restype = i
    getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_size_t
    getattr(lib, f"{name}_smem_limit").argtypes = [i]
    getattr(lib, f"{name}_smem_limit").restype = i
    _libs[name] = lib
    return lib


def _guard_smem(name: str, lib: ctypes.CDLL, need: int, device: torch.device, what: str):
    limit = getattr(lib, f"{name}_smem_limit")(device.index)
    if need > limit:
        raise ValueError(f"{what} needs {need} B of shared memory; the card "
                         f"allows {limit} B per block")


def attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """Launch ``csrc/attention_fwd.cu`` on the current stream. q [B, Lq, D],
    k/v [B, Lk, D], fp32 or bf16, on the card → o [B, Lq, D]. fp32 takes
    its CUDA-core kernel; bf16 routes by the keys (:func:`fwd_route`): up
    to 256 the one-pass kernel, past them the long-route kernel; a shape
    whose route does not fit in shared memory raises. Counts each launch
    in ``attention_fwd_cuda.launches``, and those of the long route
    also in ``launches_long``, those of the fp32 route in
    ``launches_fp32``.

    Its output carries no gradient, so it raises under grad mode when an
    input requires grad: a graph goes through :func:`flash_attention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("attention_fwd_cuda's output has no grad_fn; call "
                           "flash_attention (which has a backward) in a graph")
    hd = _check("attention_fwd_cuda", num_heads, q, k, v)
    lib = _load("attention_fwd")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    route = fwd_route(q.dtype, Lk)
    code = FWD_ROUTES[route]
    _guard_smem("attention_fwd", lib, lib.attention_fwd_smem_bytes(code, Lq, Lk, hd),
                q.device, f"Lq={Lq}, Lk={Lk}, hd={hd} ({q.dtype}, {route} route)")
    o = torch.empty_like(q)
    rc = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           code, B, num_heads, Lq, Lk, hd, 1.0 / math.sqrt(hd),
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed ({route} route): cudaError {rc}")
    attention_fwd_cuda.launches += 1
    attention_fwd_cuda.launches_long += route == "long"
    attention_fwd_cuda.launches_fp32 += route == "fp32"
    return o


attention_fwd_cuda.launches = 0
attention_fwd_cuda.launches_long = 0
attention_fwd_cuda.launches_fp32 = 0


@torch.library.custom_op("signal_tpu_torch::attention_fwd", mutates_args=(),
                         device_types="cuda")
def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """The forward kernel as a registered operator,
    ``torch.ops.signal_tpu_torch.attention_fwd``: on the card
    :func:`attention_fwd_cuda` (which raises on a shape the kernel does not
    take), on the CPU :func:`flash_attention_reference`. Its backward
    (:func:`_attention_bwd`) saves only q, k and v and recomputes P. An
    exported graph holds it as one node, and a graph that holds it loads
    only where this module has been imported."""
    return attention_fwd_cuda(q, k, v, num_heads)


@attention_fwd.register_kernel("cpu")
def _attention_fwd_cpu(q, k, v, num_heads):
    return flash_attention_reference(q, k, v, num_heads)


@attention_fwd.register_fake
def _attention_fwd_fake(q, k, v, num_heads):
    return torch.empty_like(q)


def attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                       num_heads: int):
    """Launch ``csrc/attention_bwd.cu`` on the current stream. In bf16 it
    routes by length (:func:`bwd_route`): Lq, Lk <= 160 take its fused
    kernel (one head's operands on chip by TMA, dQ by query tiles then dK
    and dV by key tiles), longer sequences its long route (a row-statistics
    kernel, then a key-parallel kernel on a cluster of blocks per head; up
    to 1024 keys at any head dim and any Lq; beyond that it raises). In
    fp32 its 3xTF32 row and column kernels, at any length. q, g [B, Lq,
    D], k/v [B, Lk, D], fp32 or bf16, on the card → (dq, dk, dv) in the
    same shapes and dtype. Counts each call in
    ``attention_bwd_cuda.launches``, and those of the long route also in
    ``launches_long``, those of the fp32 route in ``launches_fp32``."""
    hd = _check("attention_bwd_cuda", num_heads, q, k, v, g)
    lib = _load("attention_bwd")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    route = bwd_route(q.dtype, Lq, Lk, hd)
    code = BWD_ROUTES[route]
    what = f"Lq={Lq}, Lk={Lk}, hd={hd} ({q.dtype}, {route} route)"
    max_keys = lib.attention_bwd_long_max_keys()
    if route == "long" and Lk > max_keys:
        raise ValueError(f"{what}: the bf16 backward's long route takes at most {max_keys} keys")
    _guard_smem("attention_bwd", lib, lib.attention_bwd_smem_bytes(code, Lq, Lk, hd),
                q.device, what)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = None
    n_stats = lib.attention_bwd_stats_floats(code, B, num_heads, Lq, Lk)
    if n_stats:
        # per query row: the softmax max, 1/sum and rowsum(dP∘P), fp32
        stats = torch.empty(n_stats, dtype=torch.float32, device=q.device)
    rc = lib.attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           None if stats is None else stats.data_ptr(),
                           code, B, num_heads, Lq, Lk, hd, 1.0 / math.sqrt(hd),
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd launch failed ({route} route): cudaError {rc}")
    attention_bwd_cuda.launches += 1
    attention_bwd_cuda.launches_long += route == "long"
    attention_bwd_cuda.launches_fp32 += route == "fp32"
    return dq, dk, dv


attention_bwd_cuda.launches = 0
attention_bwd_cuda.launches_long = 0
attention_bwd_cuda.launches_fp32 = 0


def _attention_setup(ctx, inputs, output):
    q, k, v, num_heads = inputs
    ctx.num_heads = num_heads
    ctx.save_for_backward(q, k, v)


def _attention_bwd(ctx, g):
    """The JAX ``custom_vjp``'s backward (`flash_attention.py:195-209`):
    CPU tensors take the plain version, CUDA tensors the kernel."""
    q, k, v = ctx.saved_tensors
    g = g.to(q.dtype).contiguous()   # `flash_attention.py:206`
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_reference(q, k, v, g, ctx.num_heads)
    else:
        dq, dk, dv = attention_bwd_cuda(q, k, v, g, ctx.num_heads)
    return dq, dk, dv, None


attention_fwd.register_autograd(_attention_bwd, setup_context=_attention_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Post-projection fused attention. q [B, Lq, D], k/v [B, Lk, D] arrive
    fp32 from the projections and are cast to ``compute_dtype``
    (`signal_tpu/ops/flash_attention.py:258-259`) → [B, Lq, D] in
    ``compute_dtype``, differentiable in q, k and v."""
    q, k, v = (t.to(compute_dtype).contiguous() for t in (q, k, v))
    return attention_fwd(q, k, v, num_heads)
