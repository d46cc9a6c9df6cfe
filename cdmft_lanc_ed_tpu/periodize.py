"""Periodization of cluster quantities to lattice quantities.

JAX replacement for the reference driver postprocessing
(/root/reference/drivers/auxiliary_routines.f90:8-188): the cluster-matrix
Green's function / self-energy is reduced to a periodized (Nspin*Norb)
lattice function by the Fourier phase sum over cluster sites,

    X_per(k, z) = 1/Nlat sum_{IJ} e^{-i k (R_I - R_J)} X_IJ(k, z)

Implemented as one batched einsum over (frequency, site-pair) instead of
the reference's serial loops; the per-frequency matrix inversions are
batched `jnp.linalg` calls.

Schemes (cdn_bhz_postprocessing.f90:354-568;
cdn_ssh_postprocessing.f90:210-306):
  * G-scheme     : periodize G, then Sigma_per = G0_per^{-1} - G_per^{-1}
  * Sigma-scheme : periodize Sigma directly, then G from it
  * M-scheme     : periodize the cumulant M = [(z+mu)I - Sigma]^{-1},
                   then Sigma_per = (z+mu)I - M_per^{-1} (supports partial
                   periodization onto an nsub-site unit cell)
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import EDConfig
from .utils.reshape import lso2nnn, nnn2lso, nn2so, so2nn

jax.config.update("jax_enable_x64", True)


def cluster_coords(nlat: int, nx: int, ny: int) -> np.ndarray:
    """[Nlat, ndim] integer coordinates of cluster sites (site = ix+iy*Nx,
    the drivers' indices2N convention)."""
    assert nx * ny == nlat
    if ny == 1:
        return np.arange(nx).reshape(-1, 1).astype(float)
    coords = [(ix, iy) for iy in range(ny) for ix in range(nx)]
    return np.array(coords, dtype=float)


def _phases(kpoint: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """[Nlat, Nlat]: e^{-i k (R_I - R_J)} / Nlat."""
    kr = coords @ np.asarray(kpoint)[: coords.shape[1]]
    return np.exp(-1j * (kr[:, None] - kr[None, :])) / len(coords)


def periodize_g_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                       hk_unper: np.ndarray, smats_nnn: np.ndarray,
                       z: np.ndarray) -> np.ndarray:
    """G-scheme periodized GF at one k over frequencies ``z``:
    returns [Nspin, Nspin, Norb, Norb, L]
    (periodize_g_scheme, auxiliary_routines.f90:8-70)."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    nlso = cfg.nlso
    s_lso = jnp.asarray(np.moveaxis(nnn2lso(smats_nnn, nlat, nspin, norb),
                                    -1, 0))
    eye = jnp.eye(nlso, dtype=jnp.complex128)
    a = (jnp.asarray(z)[:, None, None] + cfg.xmu) * eye \
        - jnp.asarray(hk_unper)[None] - s_lso
    g_lso = jnp.linalg.inv(a)                       # [L, nlso, nlso]
    g_nnn = lso2nnn(jnp.moveaxis(g_lso, 0, -1), nlat, nspin, norb)
    ph = jnp.asarray(_phases(kpoint, coords))
    g_per = jnp.einsum("ij,ijabcdl->abcdl", ph, g_nnn)
    return np.asarray(g_per)


def build_sigma_g_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                         hk_unper: np.ndarray, hk_per: np.ndarray,
                         smats_nnn: np.ndarray, z: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(G_per, Sigma_per) at one k: Sigma_per = G0_per^{-1} - G_per^{-1}
    (build_sigma_g_scheme, auxiliary_routines.f90:74-131)."""
    nspin, norb = cfg.nspin, cfg.norb
    nso = nspin * norb
    g_per = periodize_g_scheme(cfg, kpoint, coords, hk_unper, smats_nnn, z)
    g_so = jnp.asarray(np.moveaxis(nn2so(g_per, nspin, norb), -1, 0))
    eye = jnp.eye(nso, dtype=jnp.complex128)
    invg0 = (jnp.asarray(z)[:, None, None] + cfg.xmu) * eye \
        - jnp.asarray(hk_per)[None]
    s_so = invg0 - jnp.linalg.inv(g_so)
    s_per = so2nn(np.moveaxis(np.asarray(s_so), 0, -1), nspin, norb)
    return g_per, s_per


def periodize_sigma_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                           hk_per: np.ndarray, smats_nnn: np.ndarray,
                           z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sigma-scheme: periodize Sigma directly, then
    G_per = [(z+mu) - Hk_per - Sigma_per]^{-1}
    (periodize_sigma_scheme, auxiliary_routines.f90:135-188)."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    nso = nspin * norb
    ph = jnp.asarray(_phases(kpoint, coords))
    s_per = jnp.einsum("ij,ijabcdl->abcdl", ph, jnp.asarray(smats_nnn))
    s_so = jnp.moveaxis(jnp.asarray(
        nn2so(np.asarray(s_per), nspin, norb)), -1, 0)
    eye = jnp.eye(nso, dtype=jnp.complex128)
    a = (jnp.asarray(z)[:, None, None] + cfg.xmu) * eye \
        - jnp.asarray(hk_per)[None] - s_so
    g_so = jnp.linalg.inv(a)
    g_per = so2nn(np.moveaxis(np.asarray(g_so), 0, -1), nspin, norb)
    return g_per, np.asarray(s_per)


def build_g_sigma_scheme(cfg: EDConfig, kpoint, coords: np.ndarray,
                         hk_per: np.ndarray, smats_nnn: np.ndarray,
                         z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(G_per, Sigma_per) with Sigma periodized first and G rebuilt from
    it — the reference's fourth scheme (build_g_sigma_scheme,
    auxiliary_routines.f90:164-193).  Identical math to
    :func:`periodize_sigma_scheme`, returned in the (G, Sigma) order the
    reference uses."""
    g_per, s_per = periodize_sigma_scheme(cfg, kpoint, coords, hk_per,
                                          smats_nnn, z)
    return g_per, s_per


def periodize_m_scheme_local(cfg: EDConfig, kpoint, coords: np.ndarray,
                             h_local_cluster: np.ndarray,
                             hk_per_hop: np.ndarray,
                             hk_per_full: np.ndarray,
                             s_nnn: np.ndarray, z: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """BHZ-style cumulant (M-scheme) periodization
    (periodize_sigma_Mscheme_mats/real, cdn_bhz_postprocessing.f90:
    641-712,580-639 — the reference zeroes ts/lambda around the G build
    and Mh around the G0 subtraction; here the split is explicit):

        M(z)        = [(z+mu)I - H_local - Sigma(z)]^{-1}   (cluster)
        M_per(k,z)  = 1/Nlat sum_IJ e^{-ik(R_I-R_J)} M_IJ(z)
        G_per^{-1}  = M_per^{-1} - Hk_hop(k)
        Sigma_per   = (z+mu)I - Hk_full(k) - G_per^{-1}

    ``h_local_cluster`` is the k-independent local cluster Hamiltonian
    (hoppings zeroed; [Nlso, Nlso]); ``hk_per_hop`` the periodized
    Bloch Hamiltonian with the LOCAL part zeroed and ``hk_per_full`` the
    full one ([Nso, Nso]).  Returns (G_per, Sigma_per) as
    [Nspin, Nspin, Norb, Norb, L] arrays.  With Sigma = 0 this is exactly
    the Sigma-scheme result (the cumulant reduces to the local G0)."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    nlso, nso = cfg.nlso, nspin * norb
    s_lso = jnp.asarray(np.moveaxis(nnn2lso(s_nnn, nlat, nspin, norb),
                                    -1, 0))
    eye = jnp.eye(nlso, dtype=jnp.complex128)
    m = jnp.linalg.inv(
        (jnp.asarray(z)[:, None, None] + cfg.xmu) * eye
        - jnp.asarray(h_local_cluster)[None] - s_lso)   # [L, nlso, nlso]
    m6 = lso2nnn(jnp.moveaxis(m, 0, -1), nlat, nspin, norb)
    ph = jnp.asarray(_phases(kpoint, coords))
    m_per = jnp.einsum("ij,ijabcdl->abcdl", ph, m6)
    m_so = jnp.moveaxis(jnp.asarray(
        nn2so(np.asarray(m_per), nspin, norb)), -1, 0)  # [L, nso, nso]
    eye_s = jnp.eye(nso, dtype=jnp.complex128)
    ginv = jnp.linalg.inv(m_so) - jnp.asarray(hk_per_hop)[None]
    s_so = (jnp.asarray(z)[:, None, None] + cfg.xmu) * eye_s \
        - jnp.asarray(hk_per_full)[None] - ginv
    g_so = jnp.linalg.inv(ginv)
    g_per = so2nn(np.moveaxis(np.asarray(g_so), 0, -1), nspin, norb)
    s_per = so2nn(np.moveaxis(np.asarray(s_so), 0, -1), nspin, norb)
    return g_per, s_per


def periodize_m_scheme(cfg: EDConfig, kpoint, cell_pos: np.ndarray,
                       site_sub: np.ndarray, nsub: int,
                       s_nnn: np.ndarray, z: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulant (M-scheme) periodization onto an ``nsub``-site unit cell.

    The cluster cumulant M(z) = [(z+mu)I - Sigma(z)]^{-1} is Fourier-summed
    over unit-cell positions, keeping the within-cell (sublattice)
    structure:

        M_per[s1,s2](k,z) = 1/Ncell sum_{ij} e^{-i k.(R_i-R_j)} M_ij(z)

    with R_i the CELL position of cluster site i (``cell_pos[i]``) and
    s_i = ``site_sub[i]`` its sublattice index.  Returns
    (M_per, Sigma_per) as [nsub*Nspin*Norb, ..., L] lso arrays with
    Sigma_per = (z+mu)I - M_per^{-1}
    (periodize_sigma_Mscheme_real, cdn_ssh_postprocessing.f90:210-259;
    the intra/inter-cluster hoppings drop out of the cumulant, which the
    reference implements by zeroing vhop/whop around the G build).
    """
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    nlso = cfg.nlso
    s_lso = jnp.asarray(np.moveaxis(nnn2lso(s_nnn, nlat, nspin, norb),
                                    -1, 0))
    eye = jnp.eye(nlso, dtype=jnp.complex128)
    m = jnp.linalg.inv((jnp.asarray(z)[:, None, None] + cfg.xmu) * eye
                       - s_lso)                        # [L, nlso, nlso]
    m6 = lso2nnn(jnp.moveaxis(m, 0, -1), nlat, nspin, norb)
    cell_pos = np.asarray(cell_pos, float).reshape(nlat, -1)
    kr = cell_pos @ np.asarray(kpoint, float)[: cell_pos.shape[1]]
    ncell = nlat / nsub
    ph = np.exp(-1j * (kr[:, None] - kr[None, :])) / ncell
    u = np.zeros((nlat, nsub))
    u[np.arange(nlat), np.asarray(site_sub, int)] = 1.0
    m_per6 = jnp.einsum("ij,is,jt,ijabcdl->stabcdl", jnp.asarray(ph),
                        jnp.asarray(u), jnp.asarray(u), m6)
    m_per = jnp.moveaxis(nnn2lso(np.asarray(m_per6), nsub, nspin, norb),
                         -1, 0)                        # [L, niso, niso]
    niso = nsub * nspin * norb
    eye_s = jnp.eye(niso, dtype=jnp.complex128)
    s_per = (jnp.asarray(z)[:, None, None] + cfg.xmu) * eye_s \
        - jnp.linalg.inv(m_per)
    return (np.moveaxis(np.asarray(m_per), 0, -1),
            np.moveaxis(np.asarray(s_per), 0, -1))
