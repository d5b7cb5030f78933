"""Query compute-precision policy.  The counterpart of
``m3_tpu/query/precision.py``.

Prometheus evaluates in float64 and so does this engine by default.
``set_compute_dtype("f32")`` narrows the bulk stencil math (the temporal
functions, the grouped quantile, histogram_quantile and arithmetic
vector matching) to float32, keeping:

- window bounds exact (int64 searchsorted);
- the rate family's counter differences in float64 (only the
  differences narrow);
- regression stencils (deriv/predict_linear) in float64 always;
- comparison operators in float64 (narrowing flips booleans for
  float64-distinct operands);
- the float64 API surface: blocks are float64 on exit.

Selection: ``set_compute_dtype("f32"|"f64")``; the default is f64.  The
reference also reads ``M3_QUERY_DTYPE`` at import; the port reads no
environment (it has no env seams), so that variable leaves the port on
f64, and the node's config has no setting for it: the port runs f32
only where Python calls ``set_compute_dtype("f32")`` before its
queries.  The policy chooses the arithmetic and never falls back: an
unknown name raises.
"""

from __future__ import annotations

import numpy as np
import torch

_VALID = {"f32": np.float32, "f64": np.float64}
_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}
_dtype = _VALID["f64"]


def set_compute_dtype(name: str) -> None:
    global _dtype
    if name not in _VALID:
        raise ValueError(f"query compute dtype must be f32|f64, got {name!r}")
    _dtype = _VALID[name]


def compute_dtype() -> np.dtype:
    return np.dtype(_dtype)


def compute_torch_dtype() -> torch.dtype:
    """The policy's dtype as a torch dtype."""
    return _TORCH[compute_dtype()]
