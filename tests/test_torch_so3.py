"""The port's SO(3) machinery (``repro_torch/models/gnn/so3.py``) against the
JAX package's, on the CPU.

Twins of ``tests/test_so3.py``'s cases on the port's tensors (the closed
forms of l = 0, 1; Y(R r) = D(R) Y(r) up to l = 6 and D's orthogonality at
the reference suite's rtol 1e-3 / atol 2e-4; align-to-z; CG equivariance;
the rotate round trip), then the port's outputs held to the reference's on
the same numpy inputs at 1e-5: ``sph_harm``, ``wigner_d_real`` for l = 0
to 6 (float32 tables: the reference runs with 64-bit types off), the
Euler angles, ``rotation_block_diag`` and ``rotate_coeffs`` both ways, and
the numpy tables (``clebsch_gordan_real``, ``tensor_product_paths``)
exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models.gnn import so3 as r_so3

from repro_torch.models.gnn import so3

RNG = np.random.default_rng(0)
#: the port against the reference on the same inputs (float32 sums in
#: other orders; Wigner-d at l = 6 sums alternating terms in the hundreds)
TOL = 1e-5


def random_rotation(n):
    """Random z-y-z Euler angles (float32 tensors)."""
    alpha = RNG.uniform(-np.pi, np.pi, n)
    beta = RNG.uniform(0, np.pi, n)
    gamma = RNG.uniform(-np.pi, np.pi, n)
    return tuple(torch.as_tensor(a, dtype=torch.float32) for a in (alpha, beta, gamma))


def rot_matrix(alpha, beta, gamma):
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    z, o = torch.zeros_like(ca), torch.ones_like(ca)
    Rz1 = torch.stack([torch.stack([ca, -sa, z], -1), torch.stack([sa, ca, z], -1),
                       torch.stack([z, z, o], -1)], -2)
    Ry = torch.stack([torch.stack([cb, z, sb], -1), torch.stack([z, o, z], -1),
                      torch.stack([-sb, z, cb], -1)], -2)
    Rz2 = torch.stack([torch.stack([cg, -sg, z], -1), torch.stack([sg, cg, z], -1),
                       torch.stack([z, z, o], -1)], -2)
    return Rz1 @ Ry @ Rz2


def unit_vectors(n):
    v = torch.as_tensor(RNG.normal(size=(n, 3)), dtype=torch.float32)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def test_sph_harm_l0_l1_closed_form():
    v = unit_vectors(64)
    Y = so3.sph_harm(v, 1).numpy()
    c0 = 1.0 / np.sqrt(4 * np.pi)
    c1 = np.sqrt(3.0 / (4 * np.pi))
    np.testing.assert_allclose(Y[:, 0], c0, rtol=1e-5)
    # ordering: (l=1, m=-1)=y, (m=0)=z, (m=1)=x
    v = v.numpy()
    np.testing.assert_allclose(Y[:, 1], c1 * v[:, 1], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(Y[:, 2], c1 * v[:, 2], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(Y[:, 3], c1 * v[:, 0], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("l_max", [1, 2, 3, 6])
def test_wigner_rotation_identity(l_max):
    """Y(R r) == D(R) Y(r) for random rotations and directions."""
    n = 16
    a, b, g = random_rotation(n)
    R = rot_matrix(a, b, g)
    v = unit_vectors(n)
    Rv = torch.einsum("nij,nj->ni", R, v)
    Y, YR = so3.sph_harm(v, l_max), so3.sph_harm(Rv, l_max)
    for l in range(l_max + 1):
        D = so3.wigner_d_real(a, b, g, l)
        assert D.dtype == torch.float32
        lo, hi = l * l, (l + 1) ** 2
        got = torch.einsum("nij,nj->ni", D, Y[:, lo:hi])
        np.testing.assert_allclose(got.numpy(), YR[:, lo:hi].numpy(), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("l_max", [2, 4, 6])
def test_wigner_orthogonality(l_max):
    n = 8
    a, b, g = random_rotation(n)
    for l in range(l_max + 1):
        D = so3.wigner_d_real(a, b, g, l)
        eye = torch.einsum("nij,nkj->nik", D, D).numpy()
        np.testing.assert_allclose(eye, np.broadcast_to(np.eye(2 * l + 1), eye.shape),
                                   atol=2e-4)


def test_align_to_z():
    v = unit_vectors(32)
    a, b, g = so3.align_to_z_angles(v)
    z = torch.einsum("nij,nj->ni", rot_matrix(a, b, g), v).numpy()
    np.testing.assert_allclose(z[:, 2], 1.0, atol=1e-5)
    np.testing.assert_allclose(z[:, :2], 0.0, atol=1e-5)


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 0), (1, 1, 1), (1, 1, 2), (2, 1, 1), (2, 2, 2)])
def test_cg_equivariance(l1, l2, l3):
    """(D1 a) x (D2 b) contracted with CG transforms as D3."""
    C = torch.as_tensor(so3.clebsch_gordan_real(l1, l2, l3), dtype=torch.float32)
    assert float(C.abs().max()) > 0  # non-trivial path
    n = 8
    a_, b_, g_ = random_rotation(n)
    D1, D2, D3 = (so3.wigner_d_real(a_, b_, g_, l) for l in (l1, l2, l3))
    x = torch.as_tensor(RNG.normal(size=(n, 2 * l1 + 1)), dtype=torch.float32)
    y = torch.as_tensor(RNG.normal(size=(n, 2 * l2 + 1)), dtype=torch.float32)
    lhs = torch.einsum("ijk,ni,nj->nk", C, torch.einsum("nij,nj->ni", D1, x),
                       torch.einsum("nij,nj->ni", D2, y))
    rhs = torch.einsum("nij,nj->ni", D3, torch.einsum("ijk,ni,nj->nk", C, x, y))
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-3, atol=2e-4)


def test_rotate_coeffs_roundtrip():
    l_max = 3
    n, c = 10, 4
    a, b, g = random_rotation(n)
    Ds = so3.rotation_block_diag(a, b, g, l_max)
    x = torch.as_tensor(RNG.normal(size=(n, c, so3.n_sph(l_max))), dtype=torch.float32)
    y = so3.rotate_coeffs(x, Ds, l_max)
    back = so3.rotate_coeffs(y, Ds, l_max, transpose=True)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-4)


# --- against the reference on the same inputs --------------------------------

def _angles(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-np.pi, np.pi, n).astype(np.float32),
            rng.uniform(0, np.pi, n).astype(np.float32),
            rng.uniform(-np.pi, np.pi, n).astype(np.float32))


def test_sph_harm_matches_reference():
    v = np.random.default_rng(1).normal(size=(200, 3)).astype(np.float32)
    v[0] = 0.0                        # the origin and the poles (x == 0)
    v[1] = (0.0, 0.0, 2.0)
    v[2] = (0.0, 1.5, 0.0)
    for l_max in (0, 2, 6):
        want = np.asarray(r_so3.sph_harm(jnp.asarray(v), l_max))
        got = so3.sph_harm(torch.from_numpy(v), l_max)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("l", range(7))
def test_wigner_d_real_matches_reference(l):
    a, b, g = _angles(10 + l, 64)
    b[:2] = (0.0, np.float32(np.pi))  # the poles
    want = np.asarray(r_so3.wigner_d_real(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(g), l))
    got = so3.wigner_d_real(*(torch.from_numpy(t) for t in (a, b, g)), l)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_align_and_rotate_match_reference():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(48, 3)).astype(np.float32)
    v[0] = (0.0, 0.0, 1.0)
    want = r_so3.align_to_z_angles(jnp.asarray(v))
    got = so3.align_to_z_angles(torch.from_numpy(v))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    l_max = 6
    r_Ds = r_so3.rotation_block_diag(*want, l_max)
    Ds = so3.rotation_block_diag(*got, l_max)
    assert len(Ds) == len(r_Ds) == l_max + 1
    for w, t in zip(r_Ds, Ds):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    x = rng.normal(size=(48, 5, so3.n_sph(l_max))).astype(np.float32)
    for transpose in (False, True):
        w = np.asarray(r_so3.rotate_coeffs(jnp.asarray(x), r_Ds, l_max, transpose=transpose))
        t = so3.rotate_coeffs(torch.from_numpy(x), Ds, l_max, transpose=transpose)
        np.testing.assert_allclose(t.numpy(), w, rtol=TOL, atol=TOL)


def test_host_tables_match_reference():
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(abs(l1 - l2), l1 + l2 + 1):
                assert np.array_equal(so3.clebsch_gordan_real(l1, l2, l3),
                                      r_so3.clebsch_gordan_real(l1, l2, l3))
    assert so3.tensor_product_paths(3, 2) == r_so3.tensor_product_paths(3, 2)
    for l in range(7):
        for a, b in zip(so3._wigner_d_tables(l), r_so3._wigner_d_tables(l)):
            assert np.array_equal(a, b)
    assert [so3.n_sph(l) for l in range(7)] == [r_so3.n_sph(l) for l in range(7)]
    assert so3.sh_index(3, -2) == r_so3.sh_index(3, -2)
