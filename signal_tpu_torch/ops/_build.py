"""Build and load the port's CUDA kernels (``signal_tpu_torch/csrc/*.cu``).

Each source becomes a shared library with a plain C interface, built by
``nvcc`` for ``sm_90a`` at first use into ``build/kernels/`` beside the
package (listed in ``.gitignore``) and loaded with ``ctypes``. The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded (the shared headers
``csrc/*.cuh`` count as part of every source). ``nvcc``'s report
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``<name>-<hash>.log``; :func:`ptxas_report` reads it and
:func:`hmma_counts` counts each kernel's tensor-core instructions (``HMMA``
of ``mma.sync``, ``HGMMA`` of ``wgmma``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): PATH, then
    ``$CUDA_HOME/bin``."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if not cand.exists():
        raise RuntimeError(f"{name} not found (PATH or $CUDA_HOME/bin): the CUDA "
                           "kernels are built from source at first use")
    return str(cand)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named source that has no library yet, one ``nvcc`` per
    source, all started together; → {name: library path}. Raises with
    ``nvcc``'s output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        path = library_path(name)
        out[name] = path
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, path, log))
    failed = []
    for name, proc, tmp, path, log in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
        else:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + path.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of the built ``csrc/<name>.cu`` (mangled name): registers
    and spill bytes, from ``nvcc -Xptxas -v``'s log."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        hit = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if hit:
            fn = out.setdefault(hit.group(1), {})
            continue
        if fn is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            fn["spill_stores"], fn["spill_loads"] = int(hit.group(1)), int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            fn["registers"] = int(hit.group(1))
    return out


def hmma_counts(name: str) -> Dict[str, int]:
    """Per kernel of the built ``csrc/<name>.cu`` (mangled name): the
    tensor-core instructions (``HMMA``, and the warpgroup products'
    ``HGMMA``) in ``cuobjdump -sass``."""
    text = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(build([name])[name])],
                          capture_output=True, text=True, check=True).stdout
    out: Dict[str, int] = {}
    fn = None
    for line in text.splitlines():
        hit = re.search(r"Function : ([\w$]+)", line)
        if hit:
            fn = hit.group(1)
            out[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            out[fn] += 1
    return out
