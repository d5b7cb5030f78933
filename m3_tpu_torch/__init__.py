"""PyTorch + CUDA port of m3_tpu for one NVIDIA H100: the M3TSZ codec,
the aggregator on its packed and f64 arena layouts, the query engine,
the storage node, the coordinator's rollups and the node process around
them (``server/``).

The JAX package ``m3_tpu`` stays the reference; this package mirrors its
layout and names so each function's counterpart is easy to find, and it
imports neither JAX nor anything of ``m3_tpu``.

Device rule: every entry point takes ``device=None``, which means CUDA.
With no CUDA device present that raises; the CPU runs only when the
caller asks for it (``device="cpu"``).  Below the entry points, each
hand-written kernel's wrapper routes by the tensor it is given: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (raises when there is none); anything
    else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
