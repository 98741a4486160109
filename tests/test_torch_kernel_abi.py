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
from sos_slam_tpu_torch.ops import control
from sos_slam_tpu_torch.ops import image as IMG
from sos_slam_tpu_torch.ops import tracker as TK
from sos_slam_tpu_torch.utils import convert, cuda_build, synthetic

# every extern "C" entry point of csrc/ and the argtypes its wrapper sets
ARGTYPES = {
    "launch_pyramid": IMG._PYR_ARGS,
    "launch_template_levels": WIN._TMPL_ARGS,
    "launch_ba_fused": BP._BA_ARGS,
    "ba_fused_part_floats": BP._BA_PART_ARGS,
    "launch_act_pass": BP._ACT_ARGS,
    "launch_track_res": TK._RES_ARGS,
    "launch_track_step": TK._STEP_ARGS,
    **control.ARGTYPES,
}
# the tables a launcher takes by value and their ctypes mirrors
STRUCTS = {"PyramidOut": IMG.PyramidOut, "TemplateTable": WIN.TemplateTable}
_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
_STRUCT = re.compile(r"^struct\s+(\w+)\s*\{(.*?)^\};", re.S | re.M)
_FIELD = re.compile(r"^(.*?)(\w+)\[(\w+)\]$")
_DEFINE = re.compile(r"^#define\s+(\w+)\s+(\d+)\s*$", re.M)


def _c_functions():
    out = {}
    for name in cuda_build.SOURCES:
        src = (cuda_build.SRC_DIR / f"{name}.cu").read_text()
        for fn, params in _EXTERN.findall(src):
            out[fn] = [" ".join(p.split()) for p in params.split(",")]
    return out


def _c_structs():
    """{struct name: [(field name, 'pointer' or C type, array length)]} of
    the array-of-levels tables in csrc/ (every field is `type name[N];`)."""
    out = {}
    for name in cuda_build.SOURCES:
        src = (cuda_build.SRC_DIR / f"{name}.cu").read_text()
        consts = {k: int(v) for k, v in _DEFINE.findall(src)}
        for struct, body in _STRUCT.findall(src):
            if struct not in STRUCTS:
                continue
            fields = []
            for decl in re.sub(r"//[^\n]*", "", body).split(";"):
                decl = " ".join(decl.split())
                if not decl:
                    continue
                ctype, field, n = _FIELD.match(decl).groups()
                fields.append((field, "pointer" if "*" in ctype
                               else ctype.strip(), consts[n]))
            out[struct] = fields
    return out


_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float}


def _ctype_of(param: str):
    if "*" in param:
        return ctypes.c_void_p
    base = param.split()[-2] if len(param.split()) > 1 else param
    return STRUCTS[base] if base in STRUCTS else _SCALARS[base]


def test_every_entry_point_has_argtypes():
    assert sorted(_c_functions()) == sorted(ARGTYPES)


@pytest.mark.parametrize("fn", sorted(ARGTYPES))
def test_argtypes_match_c_signature(fn):
    params = _c_functions()[fn]
    assert len(ARGTYPES[fn]) == len(params)
    for i, (got, param) in enumerate(zip(ARGTYPES[fn], params)):
        assert got is _ctype_of(param), f"{fn} argument {i}: {param}"


@pytest.mark.parametrize("struct", sorted(STRUCTS))
def test_by_value_table_matches_c_struct(struct):
    """Field order, kind and array length of a table passed by value: a
    mismatch shifts every later field and shows only on the card."""
    c_fields = _c_structs()[struct]
    py_fields = STRUCTS[struct]._fields_
    assert [f for f, _, _ in c_fields] == [f for f, _ in py_fields]
    for (field, kind, n), (_, got) in zip(c_fields, py_fields):
        want = ctypes.c_void_p if kind == "pointer" else _SCALARS[kind]
        assert got._type_ is want and got._length_ == n, f"{struct}.{field}"
    assert ctypes.sizeof(STRUCTS[struct]) == sum(
        n * ctypes.sizeof(ctypes.c_void_p if kind == "pointer"
                          else _SCALARS[kind]) for _, kind, n in c_fields)


def test_by_value_tables_hold_the_port_s_levels():
    from sos_slam_tpu_torch.utils.config import PYR_LEVELS
    assert WIN.K2_MAX_LEVELS >= PYR_LEVELS
    assert IMG.PyramidOut.dI.size == IMG.K1_MAX_LEVELS * ctypes.sizeof(
        ctypes.c_void_p)


# K5's buffers: the wrapper's column constants against csrc/tracker.cu's
K5_LAYOUT = {"K5_REC": TK.REC, "K5_R_E": TK.R_E, "K5_R_IN": TK.R_IN,
             "K5_R_SAT": TK.R_SAT, "K5_R_FT": TK.R_FT, "K5_R_FRT": TK.R_FRT,
             "K5_R_B": TK.R_B, "K5_R_H": TK.R_H, "K5_ST": TK.ST,
             "K5_S_IT": TK.S_IT, "K5_S_DONE": TK.S_DONE,
             "K5_S_LAM": TK.S_LAM, "K5_S_E": TK.S_E, "K5_S_NUM": TK.S_NUM,
             "K5_S_RMS": TK.S_RMS, "K5_S_AFF": TK.S_AFF, "K5_S_T": TK.S_T,
             "K5_S_B": TK.S_B, "K5_S_H": TK.S_H, "K5_TRI": TK.TRI,
             "K5_X_T": TK.X_T, "K5_X_AFF": TK.X_AFF, "K5_X_INC": TK.X_INC,
             "K5_PART": TK.K5_PART}


@pytest.mark.parametrize("name", sorted(K5_LAYOUT))
def test_k5_layout_matches_c_defines(name):
    """A column of K5's record, LM state or trial, or a partials row's
    width: the kernel and its wrapper (and the plain twin, which uses the
    same buffers) must agree, or a field is read from its neighbour."""
    src = (cuda_build.SRC_DIR / "tracker.cu").read_text()
    consts = {k: int(v) for k, v in _DEFINE.findall(src)}
    assert consts[name] == K5_LAYOUT[name]


def test_k5_buffers_hold_their_fields():
    """The record, the state and the trial hold every field without
    overlap, and a block's points are its threads times points a thread."""
    src = (cuda_build.SRC_DIR / "tracker.cu").read_text()
    consts = {k: int(v) for k, v in _DEFINE.findall(src)}
    assert consts["K5_THREADS"] * consts["K5_PPT"] == TK.K5_POINTS
    rec = [(TK.R_E, 1), (TK.R_IN, 1), (TK.R_SAT, 1), (TK.R_FT, 1),
           (TK.R_FRT, 1), (TK.R_B, 8), (TK.R_H, 64)]
    st = [(c, n or 1) for c, n, _ in TK._FIELDS.values()]
    tri = [(TK.X_T, 16), (TK.X_AFF, 2), (TK.X_INC, 1)]
    for fields, width in ((rec, TK.REC), (st, TK.ST), (tri, TK.TRI)):
        cols = [c + i for c, n in fields for i in range(n)]
        assert len(cols) == len(set(cols)) and max(cols) < width
    # E, num_in, num_sat, active, 44 normal-sum entries, 3 flow sums
    assert consts["K5_P_M"] == 4 and consts["K5_P_FLOW"] == 4 + 44
    assert TK.K5_PART == consts["K5_P_FLOW"] + 3


def test_empty_views_are_contiguous_and_16_byte_aligned():
    shapes = [(31, 41, 3), (15, 20, 3), (7, 10, 3), (3, 5)]
    views = cuda_build.empty_views(shapes, torch.float32, "cpu")
    base = views[0].data_ptr()
    for v, shape in zip(views, shapes):
        assert v.shape == shape and v.is_contiguous()
        assert (v.data_ptr() - base) % 16 == 0
    for a, b in zip(views, views[1:]):
        assert a.data_ptr() + a.numel() * 4 <= b.data_ptr()
    masks = cuda_build.empty_views([(31, 41), (15, 20)], torch.bool, "cpu")
    assert (masks[1].data_ptr() - masks[0].data_ptr()) % 4 == 0


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
