"""Numerical helpers with the JAX package's semantics on every device.

* `solve` / `inv`: like jnp.linalg, a singular system yields NaN (which
  callers turn into a zero step) instead of raising, as torch.linalg does.
* `live_pinv`: the pseudo-inverse of a symmetric matrix over its
  numerically live eigen-directions, with no host read.
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


def live_pinv(A: torch.Tensor, cut: float) -> torch.Tensor:
    """The pseudo-inverse of the symmetric A over its eigen-directions
    whose eigenvalue exceeds `cut` times the largest |eigenvalue|:
    V_l diag(1 / w_l) V_l^T, in A's dtype (float64 for a cut near f32's
    rounding). No eigendecomposition (on a card it reads its status back
    to the host): the largest |eigenvalue| comes from a power iteration,
    the projector P onto the live directions is (I + sign(A - tau I)) / 2
    with the matrix sign from Newton's iteration X <- (X + X^-1) / 2, and
    the result is P (A P + I - P)^-1 P."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    A = 0.5 * (A + A.T)
    v = torch.ones(n, dtype=A.dtype, device=A.device)
    for _ in range(30):
        v = A @ v
        v = v / torch.linalg.vector_norm(v).clamp(min=1e-300)
    lam = torch.linalg.vector_norm(A @ v).clamp(min=1e-300)
    X = (A - cut * lam * eye) / lam
    # eigenvalues down to ~1e-6 of the largest reach +-1 in ~25 steps
    for _ in range(40):
        X = 0.5 * (X + inv(X))
        X = 0.5 * (X + X.T)
    P = 0.5 * (eye + X)
    G = P @ inv(A @ P + eye - P) @ P
    return 0.5 * (G + G.T)


def scatter_sum(index: torch.Tensor, values: torch.Tensor, n: int):
    """out[i] = sum of values[j] over index[j] == i, added in j order."""
    order = torch.argsort(index, stable=True)
    buckets, counts = torch.unique_consecutive(index[order],
                                               return_counts=True)
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    out[buckets] = torch.segment_reduce(values[order], "sum", lengths=counts)
    return out
