"""The seam between the port's Python wrappers and its CUDA sources, as far
as it can be held on the CPU: a wrapper's ctypes `argtypes` against the C
signature it calls (a mismatch cuts a pointer to 32 bits and shows only on
the card), and K3's input packing, which must hand the kernel the window's
own tensors and copy nothing that already has the kernel's type."""

import ctypes
import re

import numpy as np
import pytest
import torch

from sos_slam_tpu_torch.models import window as WIN
from sos_slam_tpu_torch.ops import ba as B
from sos_slam_tpu_torch.ops import ba_p as BP
from sos_slam_tpu_torch.ops import image as IMG
from sos_slam_tpu_torch.utils import convert, cuda_build, synthetic

# every extern "C" entry point of csrc/ and the argtypes its wrapper sets
ARGTYPES = {
    "launch_pyramid_level": IMG._PYR_ARGS,
    "launch_template_level": WIN._TMPL_ARGS,
    "launch_ba_fused": BP._BA_ARGS,
    "ba_fused_part_floats": BP._BA_PART_ARGS,
    "launch_act_pass": BP._ACT_ARGS,
}
_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _c_functions():
    out = {}
    for name in cuda_build.SOURCES:
        src = (cuda_build.SRC_DIR / f"{name}.cu").read_text()
        for fn, params in _EXTERN.findall(src):
            out[fn] = [" ".join(p.split()) for p in params.split(",")]
    return out


def _ctype_of(param: str):
    if "*" in param:
        return ctypes.c_void_p
    base = param.split()[-2] if len(param.split()) > 1 else param
    return {"int": ctypes.c_int, "float": ctypes.c_float}[base]


def test_every_entry_point_has_argtypes():
    assert sorted(_c_functions()) == sorted(ARGTYPES)


@pytest.mark.parametrize("fn", sorted(ARGTYPES))
def test_argtypes_match_c_signature(fn):
    params = _c_functions()[fn]
    assert len(ARGTYPES[fn]) == len(params)
    for i, (got, param) in enumerate(zip(ARGTYPES[fn], params)):
        assert got is _ctype_of(param), f"{fn} argument {i}: {param}"


def _window(P=100, F=5):
    fields, _ = synthetic.make_window(P, F, seed=1)
    ba = convert.from_numpy(B.BAState, fields, "cpu")
    return ba, B.make_precalc(ba)


def test_k3_pack_copies_nothing_of_the_kernels_type():
    ba, pre = _window()
    pmask = ba.pt_valid.clone()
    packed = BP.k3_pack(ba, pre, pmask)
    given = [ba.u, ba.v, ba.idepth, ba.idepth_zero, ba.pt_prior, ba.pt_valid,
             pmask, ba.color, ba.weight, ba.host, ba.res_exist, ba.res_state,
             pre.R0, pre.t0, pre.affLL, ba.c, ba.c_zero, pre.b0,
             ba.energy_th, ba.frame_valid, pre.adHTdelta, pre.adHost,
             pre.adTarget]
    assert len(packed) == len(given)
    for i, (p, g) in enumerate(zip(packed, given)):
        assert p.is_contiguous(), i
        if g.is_contiguous():
            assert p.data_ptr() == g.data_ptr(), f"input {i} was copied"
        else:       # a strided view (b0 is a column of the affine states)
            assert torch.equal(p, g)
    assert BP.k3_pack(ba, pre, None)[6] is None


def test_k3_pack_converts_what_is_not():
    ba, pre = _window()
    ba2 = ba._replace(host=ba.host.long(), res_exist=ba.res_exist.float(),
                      u=ba.u.double())
    packed = BP.k3_pack(ba2, pre, None)
    assert packed[0].dtype == torch.float32
    assert packed[9].dtype == torch.int32
    assert packed[10].dtype == torch.bool
    assert torch.equal(packed[9], ba.host)
    assert torch.equal(packed[10], ba.res_exist)
    # a wide (16-byte) input that starts off 16 bytes is moved, not passed
    base = torch.zeros(ba.P * 8 + 1)
    odd = base[1:].view(ba.P, 8)
    assert odd.data_ptr() % 16 != 0
    moved = BP.k3_pack(ba._replace(color=odd), pre, None)[7]
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, odd)


def test_make_window_reaches_every_state():
    """The seeded window the card tests run on has all three residual
    states, free slots, mixed hosts and a live FEJ shift."""
    fields, dI = synthetic.make_window(167, 8, seed=3)
    assert dI.shape == (8, 120, 160, 3) and np.isfinite(dI).all()
    assert set(np.unique(fields["res_state"])) == {0, 1, 2}
    assert 0 < fields["pt_valid"].sum() < 167
    assert len(np.unique(fields["host"][fields["pt_valid"]])) == 8
    assert np.abs(fields["state"] - fields["state_zero"]).max() > 0
