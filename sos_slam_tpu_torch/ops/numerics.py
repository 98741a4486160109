"""Numerical helpers with the JAX package's semantics on every device.

* `solve` / `inv`: like jnp.linalg, a singular system yields NaN (which
  callers turn into a zero step) instead of raising, as torch.linalg does.
* `scatter_sum`: a scatter-add whose sums are the same on every run. On
  CUDA, `index_add_` adds floats with atomics in no fixed order, so a
  tracker template could differ from run to run and flip a keyframe
  decision; here each bucket is summed in index order.
"""

from __future__ import annotations

import torch


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched A x = b; NaN for a singular system."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info != 0)[..., None], torch.full_like(x, float("nan")),
                       x)


def inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse; NaN for a singular matrix."""
    x, info = torch.linalg.inv_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(x, float("nan")), x)


def scatter_sum(index: torch.Tensor, values: torch.Tensor, n: int):
    """out[i] = sum of values[j] over index[j] == i, added in j order."""
    order = torch.argsort(index, stable=True)
    buckets, counts = torch.unique_consecutive(index[order],
                                               return_counts=True)
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    out[buckets] = torch.segment_reduce(values[order], "sum", lengths=counts)
    return out
