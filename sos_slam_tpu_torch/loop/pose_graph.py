"""SE(3) pose-graph optimization in PyTorch (port of
sos_slam_tpu/loop/pose_graph.py, which replaces the reference's vendored
g2o in LoopHandler::optimize, LoopHandler.cpp:99-140).

One SE3 vertex per marginalized keyframe, odometry edges weighted by
dso_error / scale_error, loop edges from verified candidates, a Huber
kernel, the newest vertex fixed, 25 LM iterations.

SLAM pose graphs are a CHAIN (consecutive odometry edges) plus a few
verified loop edges, so the normal equations are block-tridiagonal plus a
low-rank correction, solved exactly in O(N) each LM iteration:

    H = A + U C U^T,     A   = chain edges + damping  (block-tridiagonal)
                         U,C = loop-edge Jacobian blocks / information
    H^-1 b = A^-1 b - A^-1 U (C^-1 + U^T A^-1 U)^-1 U^T A^-1 b   (Woodbury)

with A solved by a block-Thomas recursion over the 6x6 blocks, for b and
the 6*El columns of U in one sweep. The recursion is a Python loop over
the N vertices (two sweeps of small launches each LM iteration); the LM
accept/reject and the damping update are `torch.where` on device tensors,
so the 25 iterations read nothing back to the host.

Scatter-adds onto vertices go through one-hot products built once per
call, so a vertex that several edges touch sums them the same way on
every run (`index_add_` on CUDA adds with atomics, in no fixed order).

Edge convention (the reference's EdgeSE3 usage): an edge (a, b, T_meas)
with T_meas ~= T_wa^-1 T_wb has residual r = log(T_meas^-1 (T_wa^-1
T_wb)), Jacobians approximated at identity increments.
"""

from __future__ import annotations

import torch

from sos_slam_tpu_torch.ops.numerics import inv, solve
from sos_slam_tpu_torch.utils import lie

HUBER_DELTA = 1.0


def _edge_blocks(T, e_from, e_to, e_meas, e_info, e_valid):
    """Per-edge residual + Gauss-Newton blocks.

    Returns (r, W, Ja): residual (E,6), Huber-weighted information (E,6,6),
    and the from-vertex Jacobian (E,6,6); the to-vertex Jacobian is I."""
    Ta = T[e_from]
    Tb = T[e_to]
    rel = lie.se3_inv(Ta) @ Tb
    r = lie.se3_log(lie.se3_inv(e_meas) @ rel)
    rn = torch.sqrt(torch.einsum("ei,eij,ej->e", r, e_info, r) + 1e-12)
    w_huber = torch.where(rn < HUBER_DELTA, torch.ones_like(rn),
                          HUBER_DELTA / rn)
    W = e_info * (w_huber * e_valid)[:, None, None]
    Ja = -lie.se3_adj(lie.se3_inv(Tb) @ Ta)
    return r, W, Ja


def _edge_energy(T, e_from, e_to, e_meas, e_info, e_valid):
    Ta = T[e_from]
    Tb = T[e_to]
    rel = lie.se3_inv(Ta) @ Tb
    r = lie.se3_log(lie.se3_inv(e_meas) @ rel)
    rn2 = torch.einsum("ei,eij,ej->e", r, e_info, r)
    rn = torch.sqrt(rn2 + 1e-12)
    hub = torch.where(rn < HUBER_DELTA, rn2,
                      2 * HUBER_DELTA * rn - HUBER_DELTA ** 2)
    return torch.sum(torch.where(e_valid, hub, torch.zeros_like(hub)))


def block_tridiag_solve(D: torch.Tensor, O: torch.Tensor, B: torch.Tensor):
    """Solve the block-tridiagonal system with diagonal blocks D (N,6,6),
    super-diagonal blocks O (N,6,6) (O[i] couples i and i+1; O[N-1] must
    be zero), sub-diagonal = O^T, for RHS B (N,6,K). Block-Thomas: one
    forward and one backward sweep of 6x6 solves."""
    N = D.shape[0]
    C = [D[0]]
    Y = [B[0]]
    for i in range(1, N):
        # L = O_prev^T C_prev^-1  ->  L^T = C_prev^-T O_prev
        L = solve(C[-1].transpose(-1, -2), O[i - 1]).transpose(-1, -2)
        C.append(D[i] - L @ O[i - 1])
        Y.append(B[i] - L @ Y[-1])
    X = [None] * N
    X[N - 1] = solve(C[N - 1], Y[N - 1])
    for i in range(N - 2, -1, -1):
        X[i] = solve(C[i], Y[i] - O[i] @ X[i + 1])
    return torch.stack(X, 0)


def _onehot(idx: torch.Tensor, N: int, dtype) -> torch.Tensor:
    """(N, E) one-hot of the vertex index of each edge."""
    return (torch.arange(N, device=idx.device)[:, None]
            == idx[None, :]).to(dtype)


def _scatter(M: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[n] = sum over edges e of M[n, e] * vals[e] (vals (E, ...))."""
    E = vals.shape[0]
    return (M @ vals.reshape(E, -1)).reshape((M.shape[0],) + vals.shape[1:])


def optimize_pose_graph(
    T_wc: torch.Tensor,        # (N,4,4) vertex estimates (padded)
    v_valid: torch.Tensor,     # (N,) bool
    fixed: torch.Tensor,       # (N,) bool - fixed vertices (newest + invalid)
    c_from: torch.Tensor,      # (Ec,) int chain (odometry) edges: to = from+1
    c_to: torch.Tensor,        # (Ec,) int
    c_meas: torch.Tensor,      # (Ec,4,4) T_from^-1 T_to measurement
    c_info: torch.Tensor,      # (Ec,6,6)
    c_valid: torch.Tensor,     # (Ec,) bool
    l_from: torch.Tensor,      # (El,) int loop edges (any pair)
    l_to: torch.Tensor,        # (El,) int
    l_meas: torch.Tensor,      # (El,4,4)
    l_info: torch.Tensor,      # (El,6,6)
    l_valid: torch.Tensor,     # (El,) bool
    n_iters: int = 25,
    lam0: float = 1e-4,
) -> torch.Tensor:
    """Returns optimized (N,4,4) on T_wc's device. Updates are
    right-multiplied local eps: T <- T exp(eps)."""
    dev, dt = T_wc.device, T_wc.dtype
    N = T_wc.shape[0]
    El = l_from.shape[0]
    c_from, c_to = c_from.long(), c_to.long()
    l_from, l_to = l_from.long(), l_to.long()
    free = v_valid & ~fixed
    mfree = free.to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    # vertex <- edge one-hots, fixed across the iterations
    Mc_from, Mc_to = _onehot(c_from, N, dt), _onehot(c_to, N, dt)
    Ml_from, Ml_to = _onehot(l_from, N, dt), _onehot(l_to, N, dt)
    # super-diagonal block at min(from, to); odometry edges have
    # to = from + 1 so the block lands at `from` untransposed
    Mc_lo = _onehot(torch.minimum(c_from, c_to), N, dt)
    swap = (c_from > c_to)[:, None, None]
    both_free = l_valid & free[l_from] & free[l_to]
    a_only = l_valid & free[l_from] & ~free[l_to]
    b_only = l_valid & ~free[l_from] & free[l_to]
    act = both_free.to(dt)
    pair_free = mfree * torch.roll(mfree, -1)      # both i and i+1 free
    pair_free[N - 1] = 0.0

    def energy(T):
        return (_edge_energy(T, c_from, c_to, c_meas, c_info, c_valid)
                + _edge_energy(T, l_from, l_to, l_meas, l_info, l_valid))

    def solve_step(T, lam):
        # ---- chain blocks -> block-tridiagonal A ----
        rc, Wc, Jac = _edge_blocks(T, c_from, c_to, c_meas, c_info, c_valid)
        JaW = torch.einsum("eij,eik->ejk", Jac, Wc)          # Ja^T W
        Haa = torch.einsum("ejk,ekl->ejl", JaW, Jac)
        ba_c = torch.einsum("ejk,ek->ej", JaW, rc)
        bb_c = torch.einsum("ejk,ek->ej", Wc, rc)
        D = _scatter(Mc_from, Haa) + _scatter(Mc_to, Wc)    # Jb = I
        b = _scatter(Mc_from, ba_c) + _scatter(Mc_to, bb_c)
        O = _scatter(Mc_lo, torch.where(swap, JaW.transpose(-1, -2), JaW))

        # ---- loop blocks + their gradient ----
        rl, Wl, Jal = _edge_blocks(T, l_from, l_to, l_meas, l_info, l_valid)
        JaWl = torch.einsum("eij,eik->ejk", Jal, Wl)
        Haa_l = torch.einsum("ejk,ekl->ejl", JaWl, Jal)
        b = b + _scatter(Ml_from, torch.einsum("ejk,ek->ej", JaWl, rl)) \
            + _scatter(Ml_to, torch.einsum("ejk,ek->ej", Wl, rl))
        # a loop edge with exactly one free end (the common case: a fresh
        # loop edge targets the newest = FIXED vertex) contributes only a
        # diagonal block on the free side - tridiagonal structure intact;
        # only both-free edges need the low-rank (Woodbury) correction
        D = D + _scatter(Ml_from, Haa_l * a_only[:, None, None]) \
            + _scatter(Ml_to, Wl * b_only[:, None, None])

        # ---- damping on the FULL diagonal (chain + loop) ----
        dJa = torch.einsum("eij,eij->ej", Jal,
                           torch.einsum("eij,ejk->eik", Wl, Jal))
        diag_loop = _scatter(Ml_from, dJa * both_free[:, None]) \
            + _scatter(Ml_to, torch.diagonal(Wl, dim1=-2, dim2=-1)
                       * both_free[:, None])
        diag_full = torch.diagonal(D, dim1=-2, dim2=-1) + diag_loop
        damp = lam * torch.clamp(diag_full, min=1e-6) + 1e-8
        D = D + torch.diag_embed(damp)

        # fixed / invalid vertices: identity row, zero couplings, zero rhs
        D = torch.where(free[:, None, None], D, eye6)
        O = O * pair_free[:, None, None]
        b = b * mfree[:, None]

        # ---- A^-1 [b | U] in one sweep ----
        # U: (N,6, El,6) - column block e has Ja^T at vertex from, I at to
        U = (torch.einsum("ne,eji->niej", Ml_from, Jal)
             + torch.einsum("ne,ij->niej", Ml_to, eye6)) \
            * act[None, None, :, None]
        Um = U.reshape(N, 6, El * 6)
        X = block_tridiag_solve(D, O, torch.cat([b[..., None], Um], -1))
        x0, Y = X[..., 0], X[..., 1:]                            # A^-1 U

        # ---- Woodbury correction for the both-free loop edges ----
        # C = blockdiag(W_e); inactive edges -> identity (zero U anyway)
        Winv = inv(torch.where(both_free[:, None, None], Wl, eye6))
        Cinv = _blockdiag(Winv)
        S = Cinv + torch.einsum("nik,nil->kl", Um, Y)            # (6El,6El)
        S = 0.5 * (S + S.T)
        UtX0 = torch.einsum("nik,ni->k", Um, x0)
        z = solve(S, UtX0[:, None])[:, 0]
        return x0 - torch.einsum("nik,k->ni", Y, z)

    T = T_wc
    lam = torch.tensor(lam0, dtype=dt, device=dev)
    e_cur = energy(T)
    for _ in range(n_iters):
        x = solve_step(T, lam)
        eps = -x * mfree[:, None]
        eps = torch.where(torch.isfinite(eps), eps, torch.zeros_like(eps))
        T_new = T @ lie.se3_exp(eps)
        e_new = energy(T_new)
        accept = e_new < e_cur
        T = torch.where(accept, T_new, T)
        e_cur = torch.where(accept, e_new, e_cur)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-6, 1e4)
    return T


def _blockdiag(blocks: torch.Tensor) -> torch.Tensor:
    """(E,6,6) -> (6E,6E) block-diagonal."""
    E = blocks.shape[0]
    eye = torch.eye(E, dtype=blocks.dtype, device=blocks.device)
    return (eye[:, None, :, None] * blocks[:, :, None, :]).reshape(6 * E,
                                                                   6 * E)


def edge_information(pose_error: float, scale_error: float,
                     rot_weight: float = 1e4) -> torch.Tensor:
    """LoopEdge information matrix (LoopHandler.h:57-71): identity / pose
    error; translation block additionally / scale_error; rotation x 1e4.
    A float32 (6,6) CPU tensor, as the JAX package's is float32."""
    info = torch.eye(6) / max(pose_error, 1e-9)
    t_fac = (1.0 / scale_error) if scale_error > 0 else 1e-9
    info[:3, :3] *= t_fac
    info[3:, 3:] *= rot_weight
    return info
