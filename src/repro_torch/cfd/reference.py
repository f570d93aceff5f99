"""Pure-numpy oracles for the paper's operators (ground truth for tests).

These implement equations (1a)-(1c) of the paper literally, in float64.
"""
from __future__ import annotations

import numpy as np


def inverse_helmholtz(S: np.ndarray, D: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Eq. (1a)-(1c): t = (Sᵀ⊗Sᵀ⊗Sᵀ)u, r = D∘t, v = (S⊗S⊗S)r.

    Note Sᵀ_li = S_il, so (1a) is t_ijk = Σ S_il S_jm S_kn u_lmn and
    (1c) is v_ijk = Σ S_li S_mj S_nk r_lmn -- matching the CFDlang
    contraction pairs [[1 6][3 7][5 8]] and [[0 6][2 7][4 8]].
    """
    t = np.einsum("il,jm,kn,lmn->ijk", S, S, S, u)
    r = D * t
    v = np.einsum("li,mj,nk,lmn->ijk", S, S, S, r)
    return v


def inverse_helmholtz_batch(S, D, u):
    t = np.einsum("il,jm,kn,elmn->eijk", S, S, S, u)
    r = D * t
    v = np.einsum("li,mj,nk,elmn->eijk", S, S, S, r)
    return v


def interpolation(A: np.ndarray, u: np.ndarray) -> np.ndarray:
    """u' (M,M,M) = (A ⊗ A ⊗ A) u with A in R^{M x N}."""
    return np.einsum("il,jm,kn,lmn->ijk", A, A, A, u)


def interpolation_batch(A, u):
    return np.einsum("il,jm,kn,elmn->eijk", A, A, A, u)


def gradient(Dx, Dy, Dz, u):
    """∇u in the CFDlang layout convention (see dsl.GRADIENT_SRC):
    gx: (nx,ny,nz), gy: (ny,nx,nz), gz: (nz,nx,ny)."""
    gx = np.einsum("xl,lyz->xyz", Dx, u)
    gy = np.einsum("ym,xmz->yxz", Dy, u)
    gz = np.einsum("zn,xyn->zxy", Dz, u)
    return gx, gy, gz


def paper_flops_per_element(p: int) -> int:
    """Paper Eq. (2): N_op_el = (12p + 1) * p^3."""
    return (12 * p + 1) * p ** 3
