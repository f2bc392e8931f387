"""One pass for each GEMM epilogue of the CLIP tower's blocks at inference.

A block's products write fp32 (``ops/attention._MatmulF32``); what reads
them is bf16: the attention kernel reads q, k and v, and the residual
stream and the MLP hidden are bf16. The ATen chain between the two (the
fp32 bias add, the cast, QuickGELU as three kernels, the residual add)
costs 17 memory passes a block. Three registered operators take each
chain in one pass, with the chain's rounding points, so the bits are the
same:

* :func:`bias_cast` (q, k and v in one launch): ``bf16(acc + bias)``;
* :func:`bias_gelu` (fc): ``quick_gelu(bf16(acc + bias))``;
* :func:`bias_residual` (out-proj, c_proj): ``x + bf16(acc + bias)``.

On CPU tensors each runs that chain as it is; on CUDA tensors it launches
``csrc/tower_epilogue.cu`` (built at first use by ``ops/_build.py``) or
raises. There is no fallback from one to the other. Each has a fake
implementation, so that ``torch.export`` keeps it in a graph, and no
backward: ``models/vit.py`` routes a block through them only where grad
mode is off. No TPU kernel is replaced (XLA fuses these ops on the TPU).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from signal_tpu_torch.ops.attention import quick_gelu


def _bias_cast_plain(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return (acc + bias.float()).to(torch.bfloat16)


def _checked(name: str, bias: torch.Tensor, *accs: torch.Tensor, x=None) -> torch.Tensor:
    """Raise on anything the kernels do not take: fp32 products [..., cols]
    of one shape with cols % 8 == 0, an fp32 or bf16 bias of ``cols`` (per
    product), a bf16 ``x`` of the products' shape, all contiguous and
    16-byte aligned on one CUDA device, nothing that requires grad under
    grad mode (the outputs carry none). → the bias as the kernels read it,
    fp32."""
    acc = accs[0]
    tensors = (*accs, bias) if x is None else (*accs, bias, x)
    if not (acc.is_cuda and all(t.device == acc.device for t in tensors)):
        raise ValueError(f"{name} needs its tensors on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; call it where grad mode is off")
    if any(a.dtype != torch.float32 or a.shape != acc.shape for a in accs):
        raise ValueError(f"{name} takes fp32 products of one shape, got "
                         f"{[(a.dtype, tuple(a.shape)) for a in accs]}")
    cols = acc.shape[-1] if acc.dim() else 0
    if cols == 0 or cols % 8:
        raise ValueError(f"{name}: the last dimension ({cols}) must be a positive multiple "
                         "of 8")
    if bias.dtype not in (torch.float32, torch.bfloat16) or bias.shape != (len(accs) * cols,):
        raise ValueError(f"{name}: bias {bias.dtype} {tuple(bias.shape)}, want fp32 or bf16 "
                         f"[{len(accs) * cols}]")
    if x is not None and (x.dtype != torch.bfloat16 or x.shape != acc.shape):
        raise ValueError(f"{name}: x {x.dtype} {tuple(x.shape)}, want bf16 {tuple(acc.shape)}")
    bias = bias.float()
    for t in (*accs, bias, x):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    return bias


_lib = None


def _load() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    global _lib
    if _lib is None:
        from signal_tpu_torch.ops._build import load

        lib = load("tower_epilogue")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tower_bias_cast.argtypes = [p, p, p, p, p, p, p, i, i, p]
        lib.tower_bias_gelu.argtypes = [p, p, p, i, i, p]
        lib.tower_bias_residual.argtypes = [p, p, p, p, i, i, p]
        for fn in (lib.tower_bias_cast, lib.tower_bias_gelu, lib.tower_bias_residual):
            fn.restype = i
        _lib = lib
    return _lib


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _rows(acc: torch.Tensor) -> int:
    return acc.numel() // acc.shape[-1]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bias_cast_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``tower_bias_cast`` on the current stream: fp32 q, k, v
    products [..., D] and their packed bias [3D] → bf16(product + bias),
    three contiguous bf16 tensors. Counts each launch in
    ``bias_cast_cuda.launches``."""
    bias = _checked("bias_cast", bias, q, k, v)
    outs = tuple(torch.empty_like(t, dtype=torch.bfloat16) for t in (q, k, v))
    _launched("tower_bias_cast", _load().tower_bias_cast(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        *(o.data_ptr() for o in outs), _rows(q), q.shape[-1], _stream(q)))
    bias_cast_cuda.launches += 1
    return outs


def bias_gelu_cuda(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch ``tower_bias_gelu`` on the current stream: fp32 product
    [..., F] and bias [F] → quick_gelu(bf16(product + bias)) in bf16.
    Counts each launch in ``bias_gelu_cuda.launches``."""
    bias = _checked("bias_gelu", bias, acc)
    out = torch.empty_like(acc, dtype=torch.bfloat16)
    _launched("tower_bias_gelu", _load().tower_bias_gelu(
        acc.data_ptr(), bias.data_ptr(), out.data_ptr(), _rows(acc), acc.shape[-1],
        _stream(acc)))
    bias_gelu_cuda.launches += 1
    return out


def bias_residual_cuda(acc: torch.Tensor, bias: torch.Tensor, x: torch.Tensor
                       ) -> torch.Tensor:
    """Launch ``tower_bias_residual`` on the current stream: fp32 product
    [..., D], bias [D] and the bf16 residual stream x → x + bf16(product +
    bias) in bf16, a new tensor. Counts each launch in
    ``bias_residual_cuda.launches``."""
    bias = _checked("bias_residual", bias, acc, x=x)
    out = torch.empty_like(x)
    _launched("tower_bias_residual", _load().tower_bias_residual(
        acc.data_ptr(), bias.data_ptr(), x.data_ptr(), out.data_ptr(), _rows(acc),
        acc.shape[-1], _stream(acc)))
    bias_residual_cuda.launches += 1
    return out


bias_cast_cuda.launches = 0
bias_gelu_cuda.launches = 0
bias_residual_cuda.launches = 0


@torch.library.custom_op("signal_tpu_torch::bias_cast", mutates_args=(), device_types="cuda")
def bias_cast(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v's epilogue, ``torch.ops.signal_tpu_torch.bias_cast``: the
    fp32 products and their packed bias [3D] (``in_proj_bias``) → each
    bf16(product + its third of the bias), what the attention kernel
    reads. On the card :func:`bias_cast_cuda`."""
    return bias_cast_cuda(q, k, v, bias)


@bias_cast.register_kernel("cpu")
def _bias_cast_cpu(q, k, v, bias):
    return tuple(_bias_cast_plain(a, b) for a, b in zip((q, k, v), bias.chunk(3)))


@bias_cast.register_fake
def _bias_cast_fake(q, k, v, bias):
    return tuple(torch.empty_like(t, dtype=torch.bfloat16) for t in (q, k, v))


@torch.library.custom_op("signal_tpu_torch::bias_gelu", mutates_args=(), device_types="cuda")
def bias_gelu(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fc's epilogue, ``torch.ops.signal_tpu_torch.bias_gelu``: the fp32
    product and its bias → quick_gelu(bf16(product + bias)) in bf16, the
    MLP hidden. On the card :func:`bias_gelu_cuda`."""
    return bias_gelu_cuda(acc, bias)


@bias_gelu.register_kernel("cpu")
def _bias_gelu_cpu(acc, bias):
    return quick_gelu(_bias_cast_plain(acc, bias))


@bias_gelu.register_fake
def _bias_gelu_fake(acc, bias):
    return torch.empty_like(acc, dtype=torch.bfloat16)


@torch.library.custom_op("signal_tpu_torch::bias_residual", mutates_args=(),
                         device_types="cuda")
def bias_residual(acc: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The out-projection's and c_proj's epilogue,
    ``torch.ops.signal_tpu_torch.bias_residual``: the fp32 product, its
    bias and the bf16 residual stream x → x + bf16(product + bias), the
    stream after the branch. On the card :func:`bias_residual_cuda`."""
    return bias_residual_cuda(acc, bias, x)


@bias_residual.register_kernel("cpu")
def _bias_residual_cpu(acc, bias, x):
    return x + (acc + bias.float()).to(x.dtype)


@bias_residual.register_fake
def _bias_residual_fake(acc, bias, x):
    return torch.empty_like(x)
