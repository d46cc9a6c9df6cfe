"""Lattice layer: k-grids, local Green's function, DMFT self-consistency.

JAX replacement for the external DMFTtools routines the reference
drivers rely on (SURVEY.md section 2.2): ``dmft_gloc_matsubara/realaxis``,
``dmft_self_consistency``, ``check_convergence``, ``dmft_kinetic_energy``,
``TB_build_kgrid``.  Everything is batched dense linear algebra over the
(k, omega) product space — embarrassingly parallel and executed as chunked
``jnp.linalg`` batches on device (the reference loops serially over k and
omega on each rank).

Array conventions match the solver: cluster functions in 'nnn' shape
[Nlat,Nlat,Nspin,Nspin,Norb,Norb,L]; H(k) in lso shape [Nk, Nlso, Nlso].
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import EDConfig
from .utils.reshape import lso2nnn, nnn2lso

jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# k-grids (TB_build_kgrid replacement)
# ---------------------------------------------------------------------------

def build_kgrid(nk: int, ndim: int) -> np.ndarray:
    """Uniform Monkhorst-Pack-style grid in [0, 2pi)^ndim: [Nk^ndim, ndim]."""
    pts = 2.0 * np.pi * np.arange(nk) / nk
    grids = np.meshgrid(*([pts] * ndim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def build_hk(hk_model: Callable[[np.ndarray], np.ndarray],
             kgrid: np.ndarray) -> np.ndarray:
    """Evaluate a k-dependent Bloch Hamiltonian on the grid:
    [Nk, Nlso, Nlso] (TB_build_model replacement)."""
    return np.stack([np.asarray(hk_model(k)) for k in kgrid])


# ---------------------------------------------------------------------------
# local Green's function (dmft_gloc_matsubara/realaxis replacement)
# ---------------------------------------------------------------------------

@jax.jit
def _gloc_chunk(z: jax.Array, hk: jax.Array, sigma: jax.Array,
                xmu: float) -> jax.Array:
    """[(z+mu)I - H(k) - Sigma(z)]^{-1} averaged over k.

    z: [L], hk: [Nk, n, n], sigma: [L, n, n] -> [L, n, n]."""
    n = hk.shape[-1]
    eye = jnp.eye(n, dtype=jnp.complex128)
    a = ((z[:, None, None] + xmu) * eye - sigma)[:, None] - hk[None]
    g = jnp.linalg.inv(a)                     # [L, Nk, n, n]
    return g.mean(axis=1)


def gloc_lattice(z: np.ndarray, hk: np.ndarray, sigma_lso: np.ndarray,
                 xmu: float, chunk: int = 256) -> np.ndarray:
    """G_loc(z) = 1/Nk sum_k [(z+mu)I - H(k) - Sigma(z)]^{-1}; chunked over
    frequencies to bound the [L,Nk,n,n] device intermediate."""
    out = np.empty_like(sigma_lso)
    hk_d = jnp.asarray(hk)
    for i in range(0, len(z), chunk):
        sl = slice(i, min(i + chunk, len(z)))
        out[sl] = np.asarray(_gloc_chunk(jnp.asarray(z[sl]), hk_d,
                                         jnp.asarray(sigma_lso[sl]), xmu))
    return out


def dmft_gloc_matsubara(cfg: EDConfig, hk: np.ndarray,
                        smats_nnn: np.ndarray) -> np.ndarray:
    """Matsubara local GF in nnn shape (dmft_gloc_matsubara equivalent)."""
    wm = np.pi / cfg.beta * (2 * np.arange(smats_nnn.shape[-1]) + 1)
    s_lso = np.moveaxis(nnn2lso(smats_nnn, cfg.nlat, cfg.nspin, cfg.norb),
                        -1, 0)
    g = gloc_lattice(1j * wm, hk, s_lso, cfg.xmu)
    return lso2nnn(np.moveaxis(g, 0, -1), cfg.nlat, cfg.nspin, cfg.norb)


def dmft_gloc_realaxis(cfg: EDConfig, hk: np.ndarray,
                       sreal_nnn: np.ndarray) -> np.ndarray:
    wr = np.linspace(cfg.wini, cfg.wfin, sreal_nnn.shape[-1])
    s_lso = np.moveaxis(nnn2lso(sreal_nnn, cfg.nlat, cfg.nspin, cfg.norb),
                        -1, 0)
    g = gloc_lattice(wr + 1j * cfg.eps, hk, s_lso, cfg.xmu)
    return lso2nnn(np.moveaxis(g, 0, -1), cfg.nlat, cfg.nspin, cfg.norb)


# ---------------------------------------------------------------------------
# self-consistency (dmft_self_consistency replacement)
# ---------------------------------------------------------------------------

def dmft_self_consistency(cfg: EDConfig, gloc_nnn: np.ndarray,
                          smats_nnn: np.ndarray,
                          hloc_nnn: Optional[np.ndarray] = None,
                          scheme: Optional[str] = None) -> np.ndarray:
    """Weiss field update.

    scheme "weiss":  G0^{-1} = G_loc^{-1} + Sigma  ->  returns G0
    scheme "delta":  Delta = (z+mu)I - Hloc - [G_loc^{-1} + Sigma]
    (matches DMFTtools usage in drivers/cdn_hm_2dsquare.f90:159).
    """
    scheme = scheme or cfg.cg_scheme
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    l = gloc_nnn.shape[-1]
    g = jnp.asarray(np.moveaxis(nnn2lso(gloc_nnn, nlat, nspin, norb), -1, 0))
    s = jnp.asarray(np.moveaxis(nnn2lso(smats_nnn, nlat, nspin, norb), -1, 0))
    g0inv = jnp.linalg.inv(g) + s
    if scheme == "weiss":
        out = jnp.linalg.inv(g0inv)
    else:
        wm = np.pi / cfg.beta * (2 * np.arange(l) + 1)
        if hloc_nnn is None:
            raise ValueError("delta scheme requires hloc")
        hloc = jnp.asarray(nnn2lso(np.asarray(hloc_nnn, np.complex128),
                                   nlat, nspin, norb))
        eye = jnp.eye(cfg.nlso, dtype=jnp.complex128)
        out = (1j * wm[:, None, None] + cfg.xmu) * eye - hloc[None] - g0inv
    return lso2nnn(np.moveaxis(np.asarray(out), 0, -1), nlat, nspin, norb)


# ---------------------------------------------------------------------------
# convergence check (check_convergence replacement)
# ---------------------------------------------------------------------------

class ConvergenceCheck:
    """Relative-change convergence test with success-count semantics
    (DMFTtools check_convergence: err = sum|f - f_prev| / sum|f|)."""

    def __init__(self, threshold: float, nsuccess: int = 1):
        self.threshold = threshold
        self.nsuccess = nsuccess
        self.prev: Optional[np.ndarray] = None
        self.count = 0
        self.error = np.inf

    def __call__(self, f: np.ndarray) -> bool:
        f = np.asarray(f)
        if self.prev is None:
            self.error = np.inf
        else:
            num = np.abs(f - self.prev).sum()
            den = max(np.abs(f).sum(), 1e-300)
            self.error = num / den
        self.prev = f.copy()
        if self.error < self.threshold:
            self.count += 1
        else:
            self.count = 0
        return self.count >= self.nsuccess


# ---------------------------------------------------------------------------
# kinetic energy (dmft_kinetic_energy replacement)
# ---------------------------------------------------------------------------

def dmft_kinetic_energy(cfg: EDConfig, hk: np.ndarray,
                        smats_nnn: np.ndarray) -> float:
    """E_kin = <H_0> on the lattice.

    Tail-corrected Matsubara sum: the interacting part is summed as
    Tr[H_k (G_k - G0_k)] (fast-decaying), the free part is evaluated
    exactly from the spectrum of H_k with Fermi factors."""
    nlat, nspin, norb = cfg.nlat, cfg.nspin, cfg.norb
    l = smats_nnn.shape[-1]
    wm = np.pi / cfg.beta * (2 * np.arange(l) + 1)
    z = 1j * wm
    s_lso = np.moveaxis(nnn2lso(smats_nnn, nlat, nspin, norb), -1, 0)
    hk_d = jnp.asarray(hk)
    n = hk.shape[-1]
    eye = jnp.eye(n, dtype=jnp.complex128)

    @jax.jit
    def chunk_sum(zc, sc):
        a = ((zc[:, None, None] + cfg.xmu) * eye - sc)[:, None] - hk_d[None]
        g = jnp.linalg.inv(a)
        a0 = ((zc[:, None, None] + cfg.xmu) * eye)[:, None] - hk_d[None]
        g0 = jnp.linalg.inv(a0)
        return jnp.einsum("kab,lkba->", hk_d.astype(jnp.complex128),
                          (g - g0)).real

    acc = 0.0
    step = 256
    for i in range(0, l, step):
        sl = slice(i, min(i + step, l))
        acc += float(chunk_sum(jnp.asarray(z[sl]), jnp.asarray(s_lso[sl])))
    nk = hk.shape[0]
    ekin_int = 2.0 / cfg.beta * acc / nk      # 2/beta: +/- frequencies

    # free part: exact sum Tr[H f(H - mu)]
    evals, evecs = np.linalg.eigh(hk)
    occ = 1.0 / (1.0 + np.exp(np.clip(cfg.beta * (evals - cfg.xmu),
                                      -500, 500)))
    ekin_free = float((evals * occ).sum()) / nk

    # spin degeneracy when nspin==1 (paramagnetic convention: per-spin H)
    spin_fac = 2.0 if cfg.nspin == 1 else 1.0
    return spin_fac * (ekin_int + ekin_free)


# ---------------------------------------------------------------------------
# chemical-potential search (search_chemical_potential + ed_search_variable,
# ED_AUX_FUNX.f90:586-853)
# ---------------------------------------------------------------------------

class VariableSearch:
    """ed_search_variable (ED_AUX_FUNX.f90:586-697): secant update of a
    control variable (usually mu) toward a target density using a running
    compressibility estimate ``chich = dvar/dn`` persisted to
    ``var_compressibility.restart`` (and echoed to ``.used``)."""

    def __init__(self, nread: float, nerr: float = 1e-4,
                 ndelta: float = 0.1, work_dir: str = ".",
                 suffix: str = ""):
        import os
        self.nread = nread
        self.nerr = nerr
        self.work_dir = work_dir
        self.suffix = suffix
        self.path = os.path.join(work_dir, "var_compressibility.restart")
        self.chich = ndelta              # dvar/dn estimate (init :619)
        self.nold = 0.0
        self.var_old = 0.0
        self.count = 0
        self.totcount = 0
        if os.path.exists(self.path):
            try:
                with open(self.path) as fh:
                    self.chich = float(fh.read().split()[0])
            except (OSError, ValueError, IndexError):
                pass

    def step(self, var: float, ntmp: float,
             converged: bool = True) -> Tuple[float, bool]:
        """Returns (new_var, converged) — converged is the DMFT flag in,
        gated on |n - nread| <= nerr out (ED_AUX_FUNX.f90:686)."""
        import os
        if self.nread == 0.0:
            return var, converged
        self.count += 1
        self.totcount += 1
        if self.count == 1:
            self.var_old = var
        ndiff = ntmp - self.nread
        self._write(os.path.join(self.work_dir,
                                 "var_compressibility.used"))
        # charge compressibility chich = dvar/dn (:638-641)
        if self.count > 1:
            self.chich = (var - self.var_old) / (ntmp - self.nold + 1e-10)
        if self.chich > 10.0:
            self.chich = 2.0                       # clamp (:644)
        var_new = var - ndiff * self.chich         # (:649)
        self.nold = ntmp
        self.var_old = var
        try:
            with open(os.path.join(
                    self.work_dir, "search_variable_iteration_info"
                    + self.suffix + ".ed"), "a") as fh:
                fh.write(f"{self.totcount} {var_new:.12e} {ntmp:.12e} "
                         f"{ndiff:.12e}\n")
        except OSError:
            pass
        if abs(ndiff) > self.nerr:
            converged = False
        self._write(self.path)
        return var_new, converged

    def _write(self, path: str):
        try:
            with open(path, "w") as fh:
                fh.write(f"{self.chich:.12e}\n")
        except OSError:
            pass


class MuSearch:
    """Faithful ``search_chemical_potential`` (ED_AUX_FUNX.f90:701-853):
    fixed-step bracketing walk of mu with oscillation-triggered step
    halving, adaptive density-threshold reduction once the DMFT loop has
    converged at the current threshold, and ``xmu.restart`` persistence
    (read back by config.read_input, ED_INPUT_VARS.f90:219-228)."""

    def __init__(self, nread: float, ndelta: float = 0.1,
                 nerr: float = 1e-4, niter: int = 33,
                 work_dir: str = ".", suffix: str = ""):
        self.nread = nread
        self.ndelta = ndelta
        self.nerr = nerr
        self.niter = niter               # = nloop/3 (ED_SETUP.f90:208)
        self.work_dir = work_dir
        self.suffix = suffix
        self.count = 0
        self.totcount = 0
        self.nindex = 0
        self.nindex_hist = [0, 0, 0]     # last 3 nindex values (:746-751)
        self.nth_magnitude = -2
        self.nth_magnitude_old = -2
        self.nth = 1e-2
        self.ireduce = True

    def step(self, var: float, ntmp: float,
             converged: bool = True) -> Tuple[float, bool]:
        """One search iteration; returns (new_mu, converged)."""
        import os
        if self.nread == 0.0:
            return var, converged
        ndiff = ntmp - self.nread
        nratio = 0.5
        self.count += 1
        self.totcount += 1
        self.nindex_hist = [self.nindex] + self.nindex_hist[:2]
        if ndiff >= self.nth:
            self.nindex = -1
        elif ndiff <= -self.nth:
            self.nindex = 1
        else:
            self.nindex = 0
        ndelta_old = self.ndelta
        # halve the step when the walk oscillates (:761-766)
        osc = self.nindex != 0 and (
            self.nindex + self.nindex_hist[0] == 0
            or self.nindex + sum(self.nindex_hist) == 0)
        if osc:
            self.ndelta = ndelta_old * nratio
        if abs(ndelta_old) < 1e-9:
            ndelta_old = 0.0
            self.nindex = 0
        var = var + self.nindex * self.ndelta
        try:
            with open(os.path.join(self.work_dir, "search_mu_iteration"
                                   + self.suffix + ".ed"), "a") as fh:
                fh.write(f"{var:.12e} {ntmp:.12e} {ndiff:.12e}\n")
        except OSError:
            pass
        # adaptive threshold reduction once converged at this nth (:803-812)
        if (self.ireduce and abs(ndiff) < self.nth and converged
                and self.nth > self.nerr):
            self.nth_magnitude_old = self.nth_magnitude
            self.nth_magnitude -= 1
            self.nth = max(self.nerr, 10.0 ** self.nth_magnitude)
            self.count = 0
            converged = False
            self.ndelta = ndelta_old * nratio
        if abs(ndiff) > self.nth:
            converged = False
        # give up reducing after too many iterations at one threshold (:823)
        if self.ireduce and self.count > self.niter and not converged:
            self.ireduce = False
            self.nth = 10.0 ** self.nth_magnitude_old
        try:
            with open(os.path.join(self.work_dir, "xmu.restart"),
                      "w") as fh:
                fh.write(f"{var:.12e} {self.ndelta:.12e}\n")
        except OSError:
            pass
        return var, converged
