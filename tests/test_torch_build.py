"""The kernel build's bookkeeping, which needs no nvcc: the library's
name follows every source it is built from, and ``nvcc -Xptxas -v``'s
report is read per kernel (``chip_smoke.py`` and the CUDA tests hold the
bf16 kernels to 0 spill bytes through it)."""

from signal_tpu_torch.ops import _build

# the shape of ptxas's report for one library (CUDA 12.8, two kernels)
_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110rows_kernelIfEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110rows_kernelIfEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 404 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124attention_bwd_mma_kernelILi18EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124attention_bwd_mma_kernelILi18EEEvPK13__nv_bfloat16
    8 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compile time = 496.912 ms
"""


def _sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    csrc = _sources(tmp_path, monkeypatch)
    first = _build.library_path("k")
    assert first.parent == tmp_path / "build" and first.name.startswith("libk-")
    assert _build.library_path("k") == first
    (csrc / "h.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first


def test_ptxas_report_reads_each_kernel(tmp_path, monkeypatch):
    _sources(tmp_path, monkeypatch)
    log = _build.library_path("k").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(_LOG)
    report = _build.ptxas_report("k")
    assert report == {
        "_ZN12_GLOBAL__N_110rows_kernelIfEEvPKT_":
            {"registers": 48, "spill_stores": 0, "spill_loads": 0},
        "_ZN12_GLOBAL__N_124attention_bwd_mma_kernelILi18EEEvPK13__nv_bfloat16":
            {"registers": 168, "spill_stores": 16, "spill_loads": 8},
    }
