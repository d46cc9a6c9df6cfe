"""Custom observables: thermal averages of one-body lattice operators.

JAX re-implementation of the reference custom-observable registry
(/root/reference/ED_OBSERVABLES.f90:696-960): observables of the form

    <O> = sum_k Tr[ S(k) G(k, z) ]     (density-matrix contraction)

with G(k,z) = [(z+mu)I - H(k) - Sigma(z)]^{-1} and Sigma(z) rebuilt at
arbitrary z from the stored GF pole/weight spectrum (ed_gf_cluster).

* T=0: real integral over the imaginary axis, <O> = s_mult/pi *
  Int_0^inf dw sum_k Re Tr[S_k G_k(iw) - S_k/(iw - 1.1)] (the subtracted
  tail reproduces the reference's convergence trick,
  ED_OBSERVABLES.f90:925-930), evaluated with adaptive quadrature; each
  integrand evaluation is a BATCHED k-inversion on device (the reference
  loops serially over k).
* finite T: Matsubara sum up to n_max ~ beta*(max_exc + 2*hwband)/pi plus
  the residual contour integral over the circle |z| = R (the reference's
  scheme, ED_OBSERVABLES.f90:836-870; we evaluate G at the true complex
  frequency — the reference's `xi*omega` double-i slip is not reproduced).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bath import basis_lso_of, invg0_bath_lso
from .gf import evaluate_gf_nnn
from .utils.reshape import nnn2lso

jax.config.update("jax_enable_x64", True)


@dataclass
class _Item:
    name: str
    sij: np.ndarray            # [Nk, n, n] (k-dependent) weight matrix
    value: float = 0.0


class CustomObservables:
    """init/add/get/clear_custom_observables equivalent.  Bound to a solved
    :class:`~.solver.EDSolver` (needs gf spectrum + bath)."""

    def __init__(self, solver, hk: np.ndarray):
        self.solver = solver
        self.hk = np.asarray(hk)
        self.items: List[_Item] = []

    def add(self, name: str, sij: np.ndarray) -> None:
        """sij: [n, n] (same for all k) or [Nk, n, n]."""
        sij = np.asarray(sij, dtype=np.complex128)
        if sij.ndim == 2:
            sij = np.broadcast_to(sij, self.hk.shape).copy()
        # reference passes k-dep as [n, n, Nk]
        if sij.shape != self.hk.shape and \
                sij.shape == (self.hk.shape[1], self.hk.shape[2],
                              self.hk.shape[0]):
            sij = np.moveaxis(sij, -1, 0)
        self.items.append(_Item(name, sij))

    # -- Sigma(z) at arbitrary z from the stored spectrum ----------------
    def _sigma_lso(self, z: np.ndarray) -> np.ndarray:
        s = self.solver
        cfg = s.cfg
        g = evaluate_gf_nnn(s.gf.spectrum, cfg, z)
        g_lso = np.moveaxis(nnn2lso(g, cfg.nlat, cfg.nspin, cfg.norb), -1, 0)
        hloc_lso = jnp.asarray(nnn2lso(s.imp_hloc, cfg.nlat, cfg.nspin,
                                       cfg.norb))
        invg0 = invg0_bath_lso(jnp.asarray(z), hloc_lso, cfg.xmu,
                               jnp.asarray(s.bath.v),
                               jnp.asarray(s.bath.lam),
                               basis_lso_of(cfg, s.hb))
        return np.asarray(invg0 - jnp.linalg.inv(jnp.asarray(g_lso)))

    def _ksum(self, z: np.ndarray, sij: np.ndarray,
              subtract_tail: bool) -> np.ndarray:
        """sum_k Re Tr[S_k G_k(z)] / Nk for each z: [L] real."""
        cfg = self.solver.cfg
        sigma = self._sigma_lso(z)                    # [L, n, n]
        n = self.hk.shape[-1]
        eye = jnp.eye(n, dtype=jnp.complex128)
        a = ((jnp.asarray(z)[:, None, None] + cfg.xmu) * eye
             - sigma)[:, None] - jnp.asarray(self.hk)[None]
        gk = jnp.linalg.inv(a)                        # [L, Nk, n, n]
        tr = jnp.einsum("kab,lkba->lk", jnp.asarray(sij), gk)
        out = jnp.real(tr).mean(axis=1)
        if subtract_tail:
            tail = np.real(np.trace(sij, axis1=1, axis2=2).mean()
                           / (-1.1 + 1j * np.imag(z)))
            out = out - jnp.asarray(tail)
        return np.asarray(out)

    def compute(self) -> Dict[str, float]:
        from scipy.integrate import quad
        cfg = self.solver.cfg
        spin_mult = 3.0 - cfg.nspin
        out: Dict[str, float] = {}
        for item in self.items:
            if not cfg.finite_temp:
                def f(w):
                    return float(self._ksum(np.array([1j * w]), item.sij,
                                            subtract_tail=True)[0])
                val, _ = quad(f, 0.0, np.inf, limit=120)
                val = spin_mult * val / np.pi
            else:
                max_exc = self.solver.gf.max_exc
                nmax = int(2 * (abs(max_exc) + 2 * cfg.hwband)
                           * cfg.beta / np.pi)
                nmax = nmax // 2 if nmax % 2 == 0 else (nmax + 1) // 2
                radius = 2 * (nmax + 1) * np.pi / cfg.beta
                wn = (2 * np.arange(nmax + 1) + 1) * np.pi / cfg.beta
                ms = self._ksum(1j * wn, item.sij, subtract_tail=False)
                val = 2.0 / cfg.beta * ms.sum()

                def contour(theta):
                    w = radius * np.exp(1j * theta)
                    arg = cfg.beta * np.real(w - cfg.xmu)
                    fermi = 0.0 if arg >= 100 else \
                        1.0 / (np.exp(cfg.beta * (w - cfg.xmu)) + 1.0)
                    g = self._ksum(np.array([w]), item.sij,
                                   subtract_tail=False)[0]
                    return float(np.real(w * fermi * g) / np.pi)

                ipart, _ = quad(contour, -np.pi, np.pi, limit=80)
                val = spin_mult * (val + ipart)
            item.value = float(val)
            out[item.name] = item.value
        return out

    def write(self, path: Optional[str] = None) -> None:
        import os
        path = path or os.path.join(self.solver.cfg.work_dir,
                                    "custom_observables_last.ed")
        with open(path, "w") as fh:
            for item in self.items:
                fh.write(f"{item.name} {item.value:24.15e}\n")
