"""Numerical helpers with the JAX package's semantics on every device.

* `solve` / `inv`: like jnp.linalg, a singular system yields NaN (which
  callers turn into a zero step) instead of raising, as torch.linalg does.
* `live_pinv`: the pseudo-inverse of a symmetric matrix over its
  numerically live eigen-directions, with no host read.
* `at`: an entry at a device index, without a host read.
* `scatter_sum`: a scatter-add whose sums are the same on every run. On
  CUDA, `index_add_` adds floats with atomics in no fixed order, so a
  tracker template could differ from run to run and flip a keyframe
  decision; here each bucket is summed in index order. `bucket_sums` is
  its form without a host read (no output of a data-dependent size), for
  the keyframe chain's CUDA graph.
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


def at(x: torch.Tensor, i, dim: int = 0) -> torch.Tensor:
    """x's entry `i` along `dim`; for a 0-dim int tensor `i`, gathered on
    the device (indexing by a 0-dim tensor reads it on the host)."""
    if not torch.is_tensor(i):
        return x.select(dim, i)
    return x.index_select(dim, i.reshape(1)).squeeze(dim)


def scatter_sum(index: torch.Tensor, values: torch.Tensor, n: int):
    """out[i] = sum of values[j] over index[j] == i, added in j order."""
    order = torch.argsort(index, stable=True)
    buckets, counts = torch.unique_consecutive(index[order],
                                               return_counts=True)
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    out[buckets] = torch.segment_reduce(values[order], "sum", lengths=counts)
    return out


def bucket_sums(index: torch.Tensor, values: torch.Tensor, n: int):
    """out[i] = sum of values[j] over index[j] == i, the same on every run
    and without a host read: each value's bucket total is a fixed-order
    reduction over an (M, M) comparison of the M indices, and every member
    of a bucket writes that same total. For the M of a point window (a few
    thousand); NaN stays within its bucket."""
    same = index[:, None] == index[None, :]
    tot = torch.sum(torch.where(same, values[None, :],
                                torch.zeros_like(values)[None, :]), 1)
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_put_((index,), tot)
