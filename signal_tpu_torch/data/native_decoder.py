"""ctypes bridge to the batched JPEG decoder ``native/decoder.cpp`` (the
port's own copy of `signal_tpu/data/native_decoder.py`).

The C++ source is the JAX package's, unchanged, with the same C ABI
(``signal_decode_batch{,_packed}{,_u8}``). It is built at first use, never
at import, by ``g++`` with the flags of ``native/Makefile``, into
``build/native/`` beside the package (git-ignored) under a name that hashes
the source, the flags and the host CPU (the flags hold ``-march=native``),
as ``ops/_build.py`` does for the CUDA kernels.
It needs libjpeg's headers and library; where the build fails the decoder
is unavailable (logged once) and the loader takes its PIL path, as the JAX
loader does: decoding is host work, not the device's.

The decoded batch is a torch tensor. A decode failure raises ``IOError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = REPO / "native" / "decoder.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpthread")
FILTERS = {"bilinear": 0, "bicubic": 1}

_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None   # why the build failed: tried once per process

logger = logging.getLogger("signal_tpu_torch.data")


def _host_cpu() -> bytes:
    """The host CPU's model and instruction-set flags: ``-march=native``
    builds for them, so a library built on another CPU is not reused (it
    could die on an illegal instruction, which nothing can catch)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def library_path() -> Path:
    """Where ``native/decoder.cpp`` builds to, keyed by source, flags and
    the host CPU."""
    key = SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode() + _host_cpu()
    return BUILD_DIR / f"libsignal_decoder-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """``g++`` the source into ``path``; raises with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"g++ exit {out.returncode}: {out.stderr.strip()}")
    os.replace(tmp, path)  # atomic: a reader never sees half a file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed is not None:
        return _lib
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        # a library built on another host may not find libjpeg here
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        _failed = str(e)
        logger.warning("native JPEG decoder unavailable (%s): the loader decodes with PIL",
                       _failed)
        return None
    i, p = ctypes.c_int, ctypes.c_void_p
    for fn in (lib.signal_decode_batch, lib.signal_decode_batch_packed):
        fn.restype = i
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i, i, p, p, p, i, i]
    for fn in (lib.signal_decode_batch_u8, lib.signal_decode_batch_packed_u8):
        fn.restype = i
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i, i, p, i, i]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the decoder is built and loaded (building it on first call)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the build failed, or None."""
    _load()
    return _failed


def _c_paths(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _decode(name: str, paths: Sequence[str], shape, dtype: torch.dtype, out_h: int, out_w: int,
            num_threads: int, filter: str, mean=None, std=None):
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = torch.empty((n, *shape, out_h, out_w), dtype=dtype)
    args = [_c_paths(paths), n, out_h, out_w]
    if mean is not None:
        m = np.ascontiguousarray(mean, np.float32)
        s = np.ascontiguousarray(std, np.float32)
        args += [m.ctypes.data, s.ctypes.data]
    fails = getattr(lib, name)(*args, out.data_ptr(), num_threads, FILTERS[filter])
    if fails:
        raise IOError(f"native decoder: {fails}/{n} images failed to decode")
    return out


def decode_batch(paths: Sequence[str], out_h: int, out_w: int, mean, std,
                 num_threads: int = 4, filter: str = "bilinear") -> Optional[torch.Tensor]:
    """→ [N, 3, H, W] float32, ((x/255) − mean)/std, or None if the
    decoder is unavailable. ``filter``: 'bilinear' (PIL BILINEAR, the
    reference eval resize) or 'bicubic' (PIL BICUBIC, its train resize)."""
    return _decode("signal_decode_batch", paths, (3,), torch.float32, out_h, out_w,
                   num_threads, filter, mean, std)


def decode_batch_packed(paths: Sequence[str], out_h: int, out_w: int, mean, std,
                        num_threads: int = 4, filter: str = "bilinear") -> Optional[torch.Tensor]:
    """Packed RGB|NI|TI jpgs → [N, 3modal, 3ch, H, W] float32, or None."""
    return _decode("signal_decode_batch_packed", paths, (3, 3), torch.float32, out_h, out_w,
                   num_threads, filter, mean, std)


def decode_batch_u8(paths: Sequence[str], out_h: int, out_w: int, num_threads: int = 4,
                    filter: str = "bilinear") -> Optional[torch.Tensor]:
    """→ [N, 3, H, W] uint8 (decode and resample only; Normalize runs on
    the device), or None. Within 1 uint8 LSB of PIL on < 2 % of pixels
    (PIL resamples in int16 fixed point, the decoder in float)."""
    return _decode("signal_decode_batch_u8", paths, (3,), torch.uint8, out_h, out_w,
                   num_threads, filter)


def decode_batch_packed_u8(paths: Sequence[str], out_h: int, out_w: int, num_threads: int = 4,
                           filter: str = "bilinear") -> Optional[torch.Tensor]:
    """Packed RGB|NI|TI jpgs → [N, 3modal, 3ch, H, W] uint8, or None."""
    return _decode("signal_decode_batch_packed_u8", paths, (3, 3), torch.uint8, out_h, out_w,
                   num_threads, filter)
