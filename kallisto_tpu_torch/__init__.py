"""kallisto-tpu on PyTorch and CUDA: pseudoalignment and RNA-seq
quantification on an NVIDIA Hopper card.

A port of the JAX package `kallisto_tpu` (which stays the reference): the
host side (index build, FASTQ parsing, EC resolution, FLD, writers) is the
same numpy code, and the device work -- per-read pseudoalignment, the
128-bit read keys with the mapPair fragment length, and the float64 EM
update -- runs as hand-written CUDA kernels (csrc/), each beside a plain
PyTorch version that serves CPU tensors and the tests.

This package imports torch and numpy only: never jax, never kallisto_tpu.
"""

from typing import Optional, Union

import torch

__version__ = "0.1.0"

# Version of the reference implementation whose behavior we reproduce
# (reference: src/common.h:4 KALLISTO_VERSION "0.51.1").
KALLISTO_COMPAT_VERSION = "0.51.1"


def default_device() -> torch.device:
    """The card.  Raises when CUDA is absent: a caller that wants the CPU
    (the plain PyTorch versions of the kernels) asks for it by name."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kallisto_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> default_device(); 'cpu' -> the CPU; a CUDA device must exist."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' (CLI: --device cpu) to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
