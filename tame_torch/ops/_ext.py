"""Build and load the port's CUDA kernels, lazily, at first use.

All ``.cu`` sources and the one binding file that includes
``torch/extension.h`` go to ``torch.utils.cpp_extension.load`` in one
call.  The build lands in ``build/tame_torch/`` beside the package (a
directory ``.gitignore`` lists) and is reused while the sources are
unchanged.  Nothing here runs at import time: the CPU tests import every
module of the port on a host with no ``nvcc``.
"""

from __future__ import annotations

import functools
import pathlib

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "tame_torch"
SOURCES = ("binding.cpp", "spd.cu", "fused_fit.cu", "fused_smoother.cu",
           "fused_smoother_48.cu", "masked_contract.cu", "dual_contract.cu",
           "eta_contract.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")


@functools.cache
def load():
    """Compile (first call only) and import the kernel extension."""
    from torch.utils.cpp_extension import load as cpp_load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return cpp_load(
        name="tame_torch_kernels",
        sources=[str(CSRC / s) for s in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O3", "-std=c++17"],
        extra_cuda_cflags=list(CUDA_FLAGS),
        extra_include_paths=[str(CSRC)],
    )
