"""Shared helpers of the PyTorch port's parity tests: numpy hand-over
between the two packages and the comparisons, with the tolerances the repo
already applies between its own alternate forms:

  * float fields: rtol 2e-4, atol 2e-4 * max(1, max|a|)
    (tests/test_ba_p.py:54-57); Hessians also on their diagonal-normalized
    form (`gram_close`), at the same tolerance;
  * int / bool bookkeeping: exact (tests/test_ba_p.py:66-71);
  * a full GN solve: 5e-3 (tests/test_ba_p.py:143-144).

Both packages run on the CPU here: JAX as its own tests run it (Pallas in
interpret mode), the port through its plain PyTorch twins (device="cpu").
"""

import numpy as np
import torch

from sos_slam_tpu_torch.utils import convert

torch.set_num_threads(2)

TOL = 2e-4
GN_TOL = 5e-3


def np_(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t(x, dtype=None) -> torch.Tensor:
    """A CPU tensor from a numpy / JAX array (float64 -> float32)."""
    a = np.asarray(x)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    return torch.as_tensor(np.array(a), dtype=dtype)   # a writable copy


def close(a, b, tol=TOL):
    a, b = np_(a).astype(np.float64), np_(b).astype(np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(a)))) if a.size else 1.0
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


def gram_close(a, b, tol=TOL):
    """`close` on the Gram-normalized forms a_ij / sqrt(b_ii b_jj) and
    b_ij / sqrt(b_ii b_jj) over the last two axes (where b_ii b_jj > 0).
    Each entry of a Gram matrix (a Hessian J^T J) then lies in [-1, 1]
    whatever its rows' scale, so small rows (the exposure rows of H) are
    held to the same tolerance as the largest."""
    a, b = np_(a).astype(np.float64), np_(b).astype(np.float64)
    d = np.abs(np.diagonal(b, axis1=-2, axis2=-1))
    dd = np.sqrt(d[..., :, None] * d[..., None, :])
    dd = np.where(dd > 0, dd, 1.0)
    close(a / dd, b / dd, tol)


def exact(a, b):
    np.testing.assert_array_equal(np_(a), np_(b))


def port_state(cls, jax_state):
    """The port's NamedTuple `cls` built from a JAX NamedTuple state."""
    return convert.from_numpy(
        cls, {k: (v if k == "levels" else np.asarray(v))
              for k, v in jax_state._asdict().items()}, "cpu")


def scene_images(w, h, n, twist, plane_z=2.0):
    """The JAX package's synthetic sequence as numpy (images, poses):
    both packages then see bit-identical pixels."""
    import jax.numpy as jnp
    from sos_slam_tpu.utils import synthetic
    calib = synthetic.default_calib(w, h)
    imgs, _, poses = synthetic.make_sequence(calib, n, jnp.array(twist),
                                             plane_z=plane_z)
    return np.asarray(imgs), np.asarray(poses)


def act_inputs(seed, N=128, F=4, nan_dead=True):
    """Seeded inputs of one activation pass reduce (K4): hit, a, b, okf,
    color, weights^2, affine, oob, energy_th."""
    r = np.random.RandomState(seed)
    hit = (r.rand(N, F, 8, 3) * [200, 20, 20] - [0, 10, 10]).astype(
        np.float32)
    a = (r.randn(N, F, 8) * 30).astype(np.float32)
    b = (r.randn(N, F, 8) * 30).astype(np.float32)
    okf = (r.rand(N, F, 8) > 0.03).astype(np.float32)
    if nan_dead:   # dead (not ok) taps may hold NaN: `where`, not multiply
        hit[..., 0] = np.where(okf > 0.5, hit[..., 0], np.nan)
    color = (r.rand(N, 8) * 200).astype(np.float32)
    w2 = r.rand(N, 8).astype(np.float32)
    ap = np.stack([1 + 0.1 * r.randn(N, F), 5 * r.randn(N, F)], -1).astype(
        np.float32)
    oob = (r.rand(N, F) < 0.2).astype(np.float32)
    eth = np.full(N, 8 * 144.0, np.float32)
    return hit, a, b, okf, color, w2, ap, oob, eth
