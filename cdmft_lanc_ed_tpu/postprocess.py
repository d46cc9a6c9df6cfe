"""Postprocessing: band structures, quasiparticle weights, topology.

JAX counterpart of the reference postprocessing driver machinery
(/root/reference/drivers/cdn_bhz_postprocessing.f90:252-568 and
ED_GREENS_FUNCTIONS.f90:114-127):

* quasiparticle weight Z = [1 - Im Sigma(i w_0)/w_0]^{-1};
* topological Hamiltonian H_top(k) = H(k) + Re Sigma_per(k, w -> 0)
  (hk_topological, cdn_bhz_postprocessing.f90:307-327);
* lattice Chern number by the Fukui-Hatsugai-Suzuki plaquette method
  (the reference computes topological invariants for the BHZ runs) and the
  spin Chern / Z2 marker for spin-conserving models;
* band structure along a k path.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from .config import EDConfig
from .utils.reshape import nnn2lso


# ---------------------------------------------------------------------------
# quasiparticle weight / scattering rate (ED_GREENS_FUNCTIONS.f90:114-127)
# ---------------------------------------------------------------------------

def quasiparticle_weight(cfg: EDConfig, smats_nnn: np.ndarray) -> np.ndarray:
    """Z_a = [1 - Im Sigma_aa(i w_0)/w_0]^{-1} per diagonal lso component."""
    w0 = np.pi / cfg.beta
    s0 = nnn2lso(smats_nnn[..., 0], cfg.nlat, cfg.nspin, cfg.norb)
    return 1.0 / (1.0 - np.imag(np.diag(s0)) / w0)


def scattering_rate(cfg: EDConfig, smats_nnn: np.ndarray) -> np.ndarray:
    """Low-frequency extrapolation of -Im Sigma(i w -> 0) per component
    (from the first two Matsubara points, reference 'sig' files)."""
    w = np.pi / cfg.beta * np.array([1.0, 3.0])
    s = nnn2lso(smats_nnn[..., :2], cfg.nlat, cfg.nspin, cfg.norb)
    i1 = np.imag(np.diagonal(s[..., 0]))
    i2 = np.imag(np.diagonal(s[..., 1]))
    # linear extrapolation to w=0
    return -(i1 - (i2 - i1) / (w[1] - w[0]) * w[0])


# ---------------------------------------------------------------------------
# Z(k) matrices (zmats/zmats_component, cdn_bhz_postprocessing.f90:273-304)
# ---------------------------------------------------------------------------

def zmats_matrix(cfg: EDConfig, sigma_so_iw1: np.ndarray) -> np.ndarray:
    """Z(k) = [ |I - Im Sigma_per(k, iw_1)| / (pi/beta) |_abs ]^{-1}
    from the periodized self-energy at the first Matsubara frequency
    (zmats, cdn_bhz_postprocessing.f90:273-289)."""
    nso = sigma_so_iw1.shape[0]
    z = np.abs(np.eye(nso) - np.imag(np.asarray(sigma_so_iw1))
               / (np.pi / cfg.beta))
    return np.linalg.inv(z)


def zmats_component(cfg: EDConfig, sigma_so_iw1: np.ndarray) -> np.ndarray:
    """Component map of the reference's zmats_component
    (cdn_bhz_postprocessing.f90:291-304): diagonal carries (Z_11, Z_12)
    of the full Z matrix — used to plot the orbital-mixing weight along
    k-paths."""
    zt = zmats_matrix(cfg, sigma_so_iw1)
    z = np.zeros_like(zt)
    z[0, 0] = zt[0, 0]
    z[1, 1] = zt[0, 1]
    return z


# ---------------------------------------------------------------------------
# topological Hamiltonian + band structure
# ---------------------------------------------------------------------------

def topological_hamiltonian(hk_per: Callable[[np.ndarray], np.ndarray],
                            sigma0_of_k: Callable[[np.ndarray], np.ndarray]
                            ) -> Callable[[np.ndarray], np.ndarray]:
    """H_top(k) = H_per(k) + Re Sigma_per(k, w->0)
    (hk_topological, cdn_bhz_postprocessing.f90:307-327)."""

    def h(k):
        return np.asarray(hk_per(k)) + np.real(np.asarray(sigma0_of_k(k)))

    return h


def unperiodized_topological_hamiltonian(
        hk_cluster: Callable[[np.ndarray], np.ndarray],
        sigma_cluster_0: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
    """Cluster-BZ (unperiodized) topological Hamiltonian
    H_top(k) = H_cluster(k) + Re Sigma_cluster(w->0) on the full
    [Nlso, Nlso] cluster Bloch matrix (hk_unperiodized_topological,
    cdn_bhz_postprocessing.f90:330-348; the reference feeds the complex
    Sigma to a Hermitian band solver — the Hermitian part is Re Sigma)."""
    s0 = np.real(np.asarray(sigma_cluster_0))
    s0 = 0.5 * (s0 + s0.T)

    def h(k):
        return np.asarray(hk_cluster(k)) + s0

    return h


def band_structure(hk: Callable[[np.ndarray], np.ndarray],
                   kpath: Sequence[np.ndarray], npts: int = 40
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(kdist, bands[nk, nbands]) along the polyline ``kpath``."""
    ks: List[np.ndarray] = []
    dist = [0.0]
    for a, b in zip(kpath[:-1], kpath[1:]):
        seg = np.linspace(0, 1, npts, endpoint=False)[:, None] \
            * (np.asarray(b) - np.asarray(a))[None, :] + np.asarray(a)
        ks.extend(seg)
    ks.append(np.asarray(kpath[-1]))
    for i in range(1, len(ks)):
        dist.append(dist[-1] + np.linalg.norm(ks[i] - ks[i - 1]))
    bands = np.stack([np.linalg.eigvalsh(hk(k)) for k in ks])
    return np.asarray(dist), bands


# ---------------------------------------------------------------------------
# Chern number (Fukui-Hatsugai-Suzuki) and spin Chern / Z2
# ---------------------------------------------------------------------------

def chern_number(hk: Callable[[np.ndarray], np.ndarray],
                 reciprocal: np.ndarray, nk: int,
                 bands: Sequence[int]) -> float:
    """Lattice Chern number of the selected band subspace over the BZ
    spanned by the rows of ``reciprocal`` [2, 2]."""
    bands = list(bands)
    nb = len(bands)
    # eigenvector grid
    u = np.empty((nk, nk), dtype=object)
    for i in range(nk):
        for j in range(nk):
            k = (i / nk) * reciprocal[0] + (j / nk) * reciprocal[1]
            _, v = np.linalg.eigh(hk(k))
            u[i, j] = v[:, bands]

    def link(a, b):
        m = a.conj().T @ b
        d = np.linalg.det(m)
        return d / abs(d) if abs(d) > 1e-14 else 1.0

    total = 0.0
    for i in range(nk):
        for j in range(nk):
            u00 = u[i, j]
            u10 = u[(i + 1) % nk, j]
            u11 = u[(i + 1) % nk, (j + 1) % nk]
            u01 = u[i, (j + 1) % nk]
            f = np.angle(link(u00, u10) * link(u10, u11)
                         * link(u11, u01) * link(u01, u00))
            total += f
    return total / (2 * np.pi)


def spin_chern_z2(hk: Callable[[np.ndarray], np.ndarray],
                  reciprocal: np.ndarray, nk: int, nso: int,
                  filled_per_spin: int) -> Tuple[float, float, int]:
    """For spin-block-diagonal H (lso order: spin outer block):
    (C_up, C_dw, Z2) with Z2 = (C_up - C_dw)/2 mod 2."""
    n = nso // 2

    def block(s):
        def h(k):
            full = np.asarray(hk(k))
            return full[s * n:(s + 1) * n, s * n:(s + 1) * n]
        return h

    c_up = chern_number(block(0), reciprocal, nk,
                        range(filled_per_spin))
    c_dw = chern_number(block(1), reciprocal, nk,
                        range(filled_per_spin))
    z2 = int(round((c_up - c_dw) / 2)) % 2
    return c_up, c_dw, z2
