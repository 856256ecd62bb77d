"""Host numpy -> device tensor bridge.

The port's device entry points take the same packed inputs the JAX package
builds on the host (ops/wfa.py:751-783 for the aligner, ops/phase_kernel.py
:328-372 for phasing).  ``from_numpy`` moves them to a torch device with
identical dtypes (int8, uint8, int32, bool), so tests can feed one set of
numpy arrays to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = (np.int8, np.uint8, np.int32, np.bool_)


def _one(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # e.g. a view of a JAX array
        a = a.copy()
    if a.dtype.type not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def from_numpy(arrays, device):
    """Convert one array or a list/tuple of arrays to tensors on
    ``device`` with the same dtypes and shapes."""
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(_one(v, device) for v in arrays)
    return _one(arrays, device)
