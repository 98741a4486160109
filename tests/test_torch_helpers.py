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

import contextlib

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


@contextlib.contextmanager
def no_host_reads():
    """Refuse, inside the block, what would read a card's tensor on the
    host or copy to it from the host, as a CUDA graph's capture would: a
    tensor's bool / int / float / item / tolist / cpu / numpy, indexing by
    a 0-dim int or a bool tensor (a 0-dim index is read, a bool mask's
    size too), a Python number assigned into a tensor, torch.tensor /
    as_tensor, and the ops whose output size depends on the data
    (nonzero, unique, unique_consecutive, masked_select)."""
    def refuse(name):
        def read(*a, **kw):
            raise AssertionError(f"host read inside a captured body: {name}")
        return read

    names = ("__bool__", "item", "__int__", "__float__", "__index__",
             "tolist", "cpu", "numpy", "nonzero")
    saved = {n: getattr(torch.Tensor, n)
             for n in names + ("__getitem__", "__setitem__")}
    made = {n: getattr(torch, n) for n in (
        "tensor", "as_tensor", "nonzero", "unique", "unique_consecutive",
        "masked_select")}
    getitem, setitem = saved["__getitem__"], saved["__setitem__"]

    def indexed(x, idx):
        for i in idx if isinstance(idx, tuple) else (idx,):
            if torch.is_tensor(i) and (i.dtype == torch.bool or (
                    i.dim() == 0 and not i.is_floating_point())):
                raise AssertionError("host read inside a captured body: "
                                     "indexing by a 0-dim or bool tensor")
        return getitem(x, idx)

    def assigned(x, idx, value):
        # a Python number assigned into a card's tensor is copied from the
        # host
        if not torch.is_tensor(value):
            raise AssertionError("host-to-device copy inside a captured "
                                 "body: a Python number assigned")
        return setitem(x, idx, value)

    for n in names:
        setattr(torch.Tensor, n, refuse(n))
    torch.Tensor.__getitem__ = indexed
    torch.Tensor.__setitem__ = assigned
    # a host-to-device copy would be one on a card too
    for n in made:
        setattr(torch, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        for n, f in made.items():
            setattr(torch, n, f)


def act_inputs(seed, N=128, F=4, nan_dead=True):
    """Seeded inputs of one activation pass reduce (K4): hit, a, b, okf,
    color, weights^2, affine, oob, energy_th."""
    from sos_slam_tpu_torch.utils import synthetic
    return synthetic.make_act_inputs(N, F, seed, nan_dead)


def _imu_arrays(seed=0, F=8):
    """The JAX package's ImuState at F frames filled from a seeded numpy
    draw, as numpy arrays by field name."""
    import jax.numpy as jnp
    from sos_slam_tpu.models import imu as JIM
    r = np.random.RandomState(seed)
    base = JIM.empty_imu(F)
    filled = {}
    for k, v in base._asdict().items():
        a = np.asarray(v)
        if a.dtype == np.bool_:
            a = r.rand(*a.shape) < 0.5
        elif a.dtype == np.int32:
            a = r.randint(0, 10, a.shape)
        else:
            a = r.randn(*a.shape)
        filled[k] = np.asarray(jnp.asarray(a, v.dtype))
    return filled


def test_imu_and_stereo_round_trip():
    """utils/convert carries the JAX package's ImuState and StereoCalib
    into the port and back without changing a bit."""
    import dataclasses
    from sos_slam_tpu.models.full_system import StereoCalib as JSC
    from sos_slam_tpu.utils import synthetic as JSY
    from sos_slam_tpu_torch.models import imu as TIM
    from sos_slam_tpu_torch.models.full_system import StereoCalib as TSC
    arrays = _imu_arrays()
    imu = convert.from_numpy(TIM.ImuState, arrays, "cpu")
    assert imu.queue_i.dtype == torch.int32 and imu.scale.dim() == 0
    back = convert.to_numpy(imu)
    assert back.keys() == arrays.keys()
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        assert back[k].tobytes() == a.tobytes(), k

    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -0.11
    js = JSC(T_lr=T_lr, calib_right=JSY.default_calib(256, 192))
    d = dataclasses.asdict(js)
    ts = convert.from_numpy(TSC, d, "cpu")
    assert isinstance(ts, TSC)
    assert ts.calib_right.intrinsics(2) == js.calib_right.intrinsics(2)
    back = convert.to_numpy(ts)
    assert back["calib_right"] == d["calib_right"]
    assert back["T_lr"].dtype == np.float32
    assert back["T_lr"].tobytes() == d["T_lr"].tobytes()
