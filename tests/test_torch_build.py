"""The kernel build's host bookkeeping (engine/_build.py): nvcc's
``-Xptxas -v`` report read per kernel instantiation, and the build key that
names each library.  No nvcc or card needed."""
import shutil

from euispice_coreg_tpu_torch.engine import _build

# the shape of nvcc's -Xptxas -v report on stderr (sm_90a)
REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3eui15reduce_partialsILi6EEEvPKdPdii' for 'sm_90a'
ptxas info    : Function properties for _ZN3eui15reduce_partialsILi6EEEvPKdPdii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, 376 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117quad_score_kernelIfLi2ELi0ELi4EEEvPKT_S3_S3_Pdiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117quad_score_kernelIfLi2ELi0ELi4EEEvPKT_S3_S3_Pdiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, 1728 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117warp_score_kernelIdLi2ELi0ELi3EEEvPKT_S3_S3_S3_S3_Pdiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117warp_score_kernelIdLi2ELi0ELi3EEEvPKT_S3_S3_S3_S3_Pdiiii
    40 bytes stack frame, 36 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 80 registers, 1800 bytes smem, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117warp_score_kernelIfLi1ELi1EEEvPKT_S3_S3_S3_S3_Pdiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117warp_score_kernelIfLi1ELi1EEEvPKT_S3_S3_S3_S3_Pdiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, 416 bytes cmem[0]
"""


def test_ptxas_report_per_kernel_and_variant_keys(tmp_path, monkeypatch):
    """One entry per main kernel (the reduction is left out), with its
    template arguments, registers, shared memory and spills; a kernel with
    no lag tile (an earlier build) reads ``lag_tile`` None.  A variant of
    the sources (a changed shared header) gets another build key, so
    another library name."""
    got = _build.parse_ptxas(REPORT)
    assert got == [
        {"kernel": "quad_score_kernel", "dtype": "float32", "order": 2,
         "variant": 0, "lag_tile": 4, "registers": 80, "smem": 1728,
         "stack": 0, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "warp_score_kernel", "dtype": "float64", "order": 2,
         "variant": 0, "lag_tile": 3, "registers": 80, "smem": 1800,
         "stack": 40, "spill_stores": 36, "spill_loads": 36},
        {"kernel": "warp_score_kernel", "dtype": "float32", "order": 1,
         "variant": 1, "lag_tile": None, "registers": 56, "smem": 0,
         "stack": 0, "spill_stores": 0, "spill_loads": 0}]
    log = tmp_path / "lib.ptxas.txt"
    log.write_text(REPORT)
    monkeypatch.setitem(_build.LOG_PATHS, "quad_score", str(log))
    assert _build.ptxas_report("quad_score") == got

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    key = _build.build_key("quad_score")
    assert _build.build_key("quad_score") == key
    header = csrc / "sampling.cuh"
    header.write_text(header.read_text() + "\n// a variant\n")
    assert _build.build_key("quad_score") != key
