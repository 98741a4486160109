"""K3's inputs at a cell's own shapes, made by the benchmark from a seed (a
rewrite of the program's utils/synthetic.make_window): a BA window of P
point slots and F frames of the textured plane, built to reach every
branch of the fused BA iteration (mixed hosts, free slots, dropped, OOB
and outlier residuals, per-frame thresholds, a state moved off its FEJ
point). Everything is NumPy; `window_fields` returns the BA state's
fields by name, which the caller hands to the program's own state type."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark.scene import ring as RING

# the reference's 8-point residual pattern (dx, dy)
PATTERN = np.array([[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0],
                    [-1, 1], [0, 2]], np.float64)


def pinhole_frames(K: np.ndarray, w: int, h: int, poses: np.ndarray,
                   traffic: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N,h,w) float64, inverse depths (N,h,w)) of the plane seen
    by a rectified camera K from camera-to-world poses (N,4,4), on the
    CPU (the texture unquantized)."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    rays = np.stack([(xx - K[0, 2]) / K[0, 0], (yy - K[1, 2]) / K[1, 1],
                     np.ones_like(xx)], -1)
    tex = RING.Texture(traffic)
    z = float(traffic["plane_z_m"])
    imgs, idps = [], []
    for T in poses:
        rw = rays @ T[:3, :3].T
        s = np.maximum((z - T[2, 3]) / rw[..., 2], 1e-3)
        pw = T[:3, 3] + s[..., None] * rw
        imgs.append(tex.sample(torch.as_tensor(pw[..., :2])).numpy())
        idps.append(1.0 / s)
    return np.stack(imgs), np.stack(idps)


def gradients(img: np.ndarray) -> np.ndarray:
    """(h,w,3) [I, dx, dy]: central differences, zeroed borders."""
    dx = np.zeros_like(img)
    dy = np.zeros_like(img)
    dx[1:-1, 1:-1] = 0.5 * (img[1:-1, 2:] - img[1:-1, :-2])
    dy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return np.stack([img, dx, dy], -1)


def bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x0 = np.clip(np.floor(u), 0, w - 2).astype(np.int64)
    y0 = np.clip(np.floor(v), 0, h - 2).astype(np.int64)
    dx, dy = np.clip(u - x0, 0, 1), np.clip(v - y0, 0, 1)
    return (img[y0, x0] * (1 - dx) * (1 - dy) + img[y0, x0 + 1] * dx * (1 - dy)
            + img[y0 + 1, x0] * (1 - dx) * dy + img[y0 + 1, x0 + 1] * dx * dy)


def se3_exp_small(xi: np.ndarray) -> np.ndarray:
    """A small SE(3) step [v, w] as a (4,4) matrix (first order in v)."""
    T = np.eye(4)
    T[:3, :3] = RING.so3_exp(xi[None, 3:])[0]
    T[:3, 3] = xi[:3]
    return T


def window_fields(P: int, F: int, K: np.ndarray, w: int, h: int,
                  traffic: dict, seed: int = 0):
    """(BA state fields as numpy by name, dI (F,h,w,3) float32)."""
    r = np.random.default_rng(seed)
    flight = RING.Flight.from_traffic(traffic)
    poses = flight.poses(0.25 * np.arange(F))
    imgs, idepths = pinhole_frames(K, w, h, poses, traffic)
    dI = np.stack([gradients(im) for im in imgs]).astype(np.float32)
    T_eval = np.stack([
        (se3_exp_small((0.0 if i == 0 else 0.004) * r.standard_normal(6))
         @ poses[i]) for i in range(F)]).astype(np.float32)

    host = r.integers(0, F, P).astype(np.int32)
    u = r.uniform(8, w - 9, P)
    v = r.uniform(8, h - 9, P)
    pt_valid = r.random(P) < 0.9
    host = np.where(pt_valid, host, 0).astype(np.int32)
    idp_true = np.array([bilinear(idepths[host[i]], u[i:i + 1], v[i:i + 1])[0]
                         for i in range(P)])
    color = np.stack([bilinear(imgs[host[i]], u[i] + PATTERN[:, 0],
                               v[i] + PATTERN[:, 1]) for i in range(P)])
    idz = idp_true * (1.0 + 0.05 * r.standard_normal(P))
    idepth = idz * (1.0 + 0.01 * r.standard_normal(P))
    fr = np.arange(F)
    res_exist = (pt_valid[:, None] & (fr[None, :] != host[:, None])
                 & (r.random((P, F)) < 0.9))
    res_state = r.choice(np.array([0, 1, 2], np.int8), (P, F),
                         p=[0.9, 0.05, 0.05]).astype(np.int8)
    state = (0.003 * r.standard_normal((F, 8))).astype(np.float32)
    state[0] = 0.0
    c_zero = (np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]) / 50.0).astype(
        np.float32)
    D = 4 + 8 * F
    f32 = np.float32
    fields = dict(
        frame_valid=np.ones(F, bool), T_cw_eval=T_eval, state=state,
        state_zero=np.zeros((F, 8), f32),
        exposure=(1.0 + 0.05 * r.random(F)).astype(f32),
        energy_th=(12.0 * 12.0 * 8.0 * (0.25 + 0.75 * r.random(F))).astype(
            f32),
        prior=np.zeros((F, 8), f32),
        c=(c_zero * f32(1.001)).astype(f32), c_zero=c_zero,
        pt_valid=pt_valid, host=host, u=u.astype(f32), v=v.astype(f32),
        color=color.astype(f32),
        weight=(0.5 + 0.5 * r.random((P, 8))).astype(f32),
        idepth=(idepth * pt_valid).astype(f32),
        idepth_zero=(idz * pt_valid).astype(f32),
        pt_prior=(50.0 * r.random(P) * pt_valid).astype(f32),
        res_exist=res_exist, res_state=res_state,
        HM=np.zeros((D, D), f32), bM=np.zeros(D, f32))
    return fields, dI

