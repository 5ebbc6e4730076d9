"""SO(3) representation machinery for the equivariant GNNs, on tensors.

Real spherical harmonics, Wigner-D rotation matrices in the real basis, and
real-basis Clebsch-Gordan coefficients — what NequIP's tensor-product
messages and EquiformerV2's eSCN rotation trick need.

Conventions: real SH index ``(l, m)`` flattened as ``l*l + (m + l)``;
normalised so that Y transforms as ``Y(R r) = D(R) Y(r)`` with the D built
here.

Wigner-D path: complex Wigner-d(β) via Wigner's factorial formula
(precomputed numpy coefficient tables per l), z-y-z Euler composition, and a
fixed unitary change of basis U_l between complex and real SH.  The
l-indexed tables are numpy constants, cached per l; per-edge math runs on
the inputs' device in float32 and complex64 (the tables are cast down
before they meet a tensor, so nothing promotes to float64).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch


def n_sph(l_max: int) -> int:
    return (l_max + 1) ** 2


def sh_index(l: int, m: int) -> int:
    return l * l + m + l


# ---------------------------------------------------------------------------
# real spherical harmonics
# ---------------------------------------------------------------------------


def sph_harm(vec: torch.Tensor, l_max: int, eps: float = 1e-12) -> torch.Tensor:
    """Real spherical harmonics of unit(ised) vectors.

    vec: (..., 3) -> (..., (l_max+1)^2), ordered l*l + m + l.
    """
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    ct = z / r                                   # cos(theta)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = torch.atan2(y, x + eps * (x == 0))

    # associated Legendre P_l^m(ct) with Condon-Shortley, upward recursion
    P: Dict[Tuple[int, int], torch.Tensor] = {}
    P[(0, 0)] = torch.ones_like(ct)
    for m in range(1, l_max + 1):
        # P_m^m = (-1)^m (2m-1)!! st^m
        P[(m, m)] = (-1.0) ** m * _dfact(2 * m - 1) * st ** m
    for m in range(0, l_max):
        P[(m + 1, m)] = ct * (2 * m + 1) * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    cos_m = [torch.ones_like(phi)]
    sin_m = [torch.zeros_like(phi)]
    for m in range(1, l_max + 1):
        cos_m.append(torch.cos(m * phi))
        sin_m.append(torch.sin(m * phi))

    out = []
    for l in range(l_max + 1):
        row = [None] * (2 * l + 1)
        for m in range(0, l + 1):
            N = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - m) / math.factorial(l + m))
            # cancel Condon-Shortley so the real SH is CS-free
            base = N * ((-1.0) ** m) * P[(l, m)]
            if m == 0:
                row[sh_index(l, 0) - l * l] = base
            else:
                row[sh_index(l, m) - l * l] = math.sqrt(2.0) * base * cos_m[m]
                row[sh_index(l, -m) - l * l] = math.sqrt(2.0) * base * sin_m[m]
        out.extend(row)
    return torch.stack(out, dim=-1)


def _dfact(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


# ---------------------------------------------------------------------------
# Wigner-d / Wigner-D
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _wigner_d_tables(l: int):
    """Precompute Wigner-d(β) expansion tables for one l.

    d^l_{m',m}(β) = sum_k c_k * cos(β/2)^(2l+m-m'-2k) * sin(β/2)^(m'-m+2k)

    Returns (coef, cos_pow, sin_pow) arrays of shape (2l+1, 2l+1, K).
    """
    dim = 2 * l + 1
    kmax = 2 * l + 1
    coef = np.zeros((dim, dim, kmax))
    cpow = np.zeros((dim, dim, kmax), dtype=np.int64)
    spow = np.zeros((dim, dim, kmax), dtype=np.int64)
    f = math.factorial
    for im1, m1 in enumerate(range(-l, l + 1)):     # m'
        for im2, m2 in enumerate(range(-l, l + 1)):  # m
            pref = math.sqrt(f(l + m1) * f(l - m1) * f(l + m2) * f(l - m2))
            for k in range(max(0, m2 - m1), min(l - m1, l + m2) + 1):
                denom = f(l - m1 - k) * f(l + m2 - k) * f(k + m1 - m2) * f(k)
                coef[im1, im2, k] = ((-1.0) ** (k + m1 - m2)) * pref / denom
                cpow[im1, im2, k] = 2 * l + m2 - m1 - 2 * k
                spow[im1, im2, k] = m1 - m2 + 2 * k
    return coef, cpow, spow


@lru_cache(maxsize=None)
def _complex_to_real_basis(l: int) -> np.ndarray:
    """Unitary U with Y_real = U @ Y_complex (complex SH with CS phase).

    Real index order: m = -l..l (sin|m| ... Y_l0 ... cos m).
    """
    dim = 2 * l + 1
    U = np.zeros((dim, dim), dtype=np.complex128)
    s2 = 1.0 / math.sqrt(2.0)
    for m in range(1, l + 1):
        # Y_{l,-m}^real (sin) = i/sqrt2 (Y_{l,-m} - (-1)^m Y_{l,m})
        U[l - m, l - m] = 1j * s2
        U[l - m, l + m] = -1j * s2 * ((-1.0) ** m)
        # Y_{l,m}^real (cos) = 1/sqrt2 (Y_{l,-m} + (-1)^m Y_{l,m})
        U[l + m, l - m] = s2
        U[l + m, l + m] = s2 * ((-1.0) ** m)
    U[l, l] = 1.0
    return U


def wigner_d_real(alpha: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor,
                  l: int) -> torch.Tensor:
    """Real-basis Wigner D^l for z-y-z Euler angles (vectorised over leading
    dims).  Satisfies Y(R r) = D(R) Y(r) for the real SH above, where
    R = Rz(alpha) Ry(beta) Rz(gamma).

    The tables go in as float32 and complex64, as the JAX package computes
    them with 64-bit types off; in float64 the port would be more exact
    than its reference."""
    dev = beta.device
    coef, cpow, spow = (torch.as_tensor(a, device=dev) for a in _wigner_d_tables(l))
    coef = coef.to(torch.float32)
    cpow, spow = cpow.to(torch.float32), spow.to(torch.float32)
    cb = torch.cos(beta / 2.0)[..., None, None, None]
    sb = torch.sin(beta / 2.0)[..., None, None, None]
    d = torch.sum(coef * cb ** cpow * sb ** spow, dim=-1)  # (..., dim, dim)

    m = torch.arange(-l, l + 1, device=dev)
    # Y(R r) = M Y(r) holds for M = conj(D) in the standard convention
    # D^l_{m',m} = e^{-i m' a} d^l(b) e^{-i m g}; we build conj(D) directly
    # (d is real, so only the phases flip sign)
    ea = torch.exp(1j * m * alpha[..., None])
    eg = torch.exp(1j * m * gamma[..., None])
    Dc = ea[..., :, None] * d.to(torch.complex64) * eg[..., None, :]
    U = torch.as_tensor(_complex_to_real_basis(l), device=dev).to(torch.complex64)
    Dr = torch.einsum("ij,...jk,lk->...il", U, Dc, U.conj())
    return torch.real(Dr).to(torch.float32)


def align_to_z_angles(vec: torch.Tensor, eps: float = 1e-12):
    """Euler angles (alpha, beta, gamma) of a rotation R taking ``vec`` to
    +z: R = Rz(0) Ry(-theta) Rz(-phi)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    phi = torch.atan2(y, x + eps * (x == 0))
    zeros = torch.zeros_like(theta)
    return zeros, -theta, -phi


def rotation_block_diag(alpha, beta, gamma, l_max: int) -> List[torch.Tensor]:
    """List of per-l real D matrices (one entry per l in 0..l_max)."""
    out = [torch.ones(alpha.shape + (1, 1), dtype=torch.float32, device=alpha.device)]
    for l in range(1, l_max + 1):
        out.append(wigner_d_real(alpha, beta, gamma, l))
    return out


def rotate_coeffs(coeffs: torch.Tensor, Ds: List[torch.Tensor], l_max: int,
                  transpose: bool = False) -> torch.Tensor:
    """Apply block-diagonal rotation to (..., C, (l_max+1)^2) coefficients."""
    outs = []
    for l in range(l_max + 1):
        lo, hi = l * l, (l + 1) * (l + 1)
        blk = coeffs[..., lo:hi]
        D = Ds[l]
        eq = "...ij,...cj->...ci" if not transpose else "...ji,...cj->...ci"
        outs.append(torch.einsum(eq, D, blk))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# Clebsch-Gordan (real basis)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """Complex-basis CG coefficients <l1 m1 l2 m2 | l3 m3> via Racah."""
    f = math.factorial

    def cg(j1, m1, j2, m2, j3, m3):
        if m3 != m1 + m2:
            return 0.0
        pref = math.sqrt(
            (2 * j3 + 1)
            * f(j3 + j1 - j2) * f(j3 - j1 + j2) * f(j1 + j2 - j3)
            / f(j1 + j2 + j3 + 1)
        )
        pref *= math.sqrt(
            f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1)
            * f(j2 - m2) * f(j2 + m2)
        )
        s = 0.0
        for k in range(0, j1 + j2 - j3 + 1):
            denom_args = [
                k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
                j3 - j2 + m1 + k, j3 - j1 - m2 + k,
            ]
            if any(a < 0 for a in denom_args):
                continue
            denom = 1.0
            for a in denom_args:
                denom *= f(a)
            s += ((-1.0) ** k) / denom
        return pref * s

    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i1, m1 in enumerate(range(-l1, l1 + 1)):
        for i2, m2 in enumerate(range(-l2, l2 + 1)):
            for i3, m3 in enumerate(range(-l3, l3 + 1)):
                out[i1, i2, i3] = cg(l1, m1, l2, m2, l3, m3)
    return out


@lru_cache(maxsize=None)
def clebsch_gordan_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C with the equivariance property
    (D1 a) x (D2 b) -> contraction transforms with D3.

    Built as U1* U2* C_complex U3^T with phase fixed so the result is real
    (numpy float64; callers cast it to their tensors' type).
    """
    C = _cg_complex(l1, l2, l3).astype(np.complex128)
    U1 = _complex_to_real_basis(l1)
    U2 = _complex_to_real_basis(l2)
    U3 = _complex_to_real_basis(l3)
    # real-basis tensor: C_real[i,j,k] = sum U1[i,m1] U2[j,m2] C[m1,m2,m3] U3*[k,m3]
    out = np.einsum("im,jn,mnp,kp->ijk", U1, U2, C, U3.conj())
    # the result is either purely real or purely imaginary; normalise phase
    if np.abs(out.imag).max() > np.abs(out.real).max():
        out = out.imag
    else:
        out = out.real
    return np.ascontiguousarray(out)


def tensor_product_paths(l_max_in: int, l_max_out: int):
    """All (l1, l2, l3) with |l1-l2| <= l3 <= l1+l2 within the budgets."""
    paths = []
    for l1 in range(l_max_in + 1):
        for l2 in range(l_max_in + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max_out) + 1):
                paths.append((l1, l2, l3))
    return paths
