"""Hierarchical A/B-half Kronecker factorisation (ops/hier.py): exact
factor of a one-body spin operator as dense small-block chains —
correctness vs the ELL factor and the FLOP headline vs the tile kernel
(round-4 prototype of the Ns>=16 roofline formulation)."""
import numpy as np
import pytest

from cdmft_lanc_ed_tpu import EDConfig
from cdmft_lanc_ed_tpu.ops import hier, sector_ham
from cdmft_lanc_ed_tpu.ops.sector_ham import _one_body_terms
from cdmft_lanc_ed_tpu.utils import fock


def _plaquette_terms(nbath, spin=0):
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=nbath, uloc=[4.0],
                   ed_verbose=0)
    nn = (4, 4, 1, 1, 1, 1)
    hloc = np.zeros(nn, np.complex128)
    for (i, j) in [(0, 1), (0, 2), (1, 3), (2, 3)]:
        hloc[i, j, 0, 0, 0, 0] = hloc[j, i, 0, 0, 0, 0] = -1.0
    hrec = np.zeros((nbath,) + nn, np.complex128)
    for b in range(nbath):
        for il in range(4):
            hrec[b, il, il, 0, 0, 0, 0] = -1.0 + 2.0 * b / max(nbath - 1, 1)
    dhyb = np.full((4, 1, 1, nbath), 0.5)
    return cfg, hloc, hrec, dhyb, _one_body_terms(cfg, hloc, hrec, dhyb,
                                                  spin)


@pytest.mark.parametrize("nbath,n", [(1, 3), (1, 4), (2, 5), (2, 6)])
def test_hier_matvec_matches_ell_factor(nbath, n):
    cfg, hloc, hrec, dhyb, terms = _plaquette_terms(nbath)
    ns = cfg.ns
    states = np.asarray(fock.sector_states(ns, n), np.int64)
    ell = sector_ham._spin_hop_ell(states, terms)
    h_dense = ell.to_dense().real          # combinadic ordering

    f = hier.build_hier_factor(ns, n, terms)
    rng = np.random.default_rng(7)
    v = rng.normal(size=len(states))
    # permute to hierarchical order, apply, permute back
    vh = np.empty_like(v)
    vh[f.perm] = v
    yh = hier.matvec_hier_np(f, vh)
    y = yh[f.perm]
    np.testing.assert_allclose(y, h_dense @ v, rtol=1e-12, atol=1e-12)
    # multi-column minor axis
    vm = rng.normal(size=(len(states), 3))
    vmh = np.empty_like(vm)
    vmh[f.perm] = vm
    ym = hier.matvec_hier_np(f, vmh)[f.perm]
    np.testing.assert_allclose(ym, h_dense @ vm, rtol=1e-12, atol=1e-12)


def test_hier_flop_accounting_ns16():
    """Measured FLOP accounting at the Ns=16 half-filled factor (the
    basis for the hierarchical kernel design): the dense block chain at the even split is
    1.16x leaner than the 128x128 tile kernel's padded MACs (21.0M vs
    24.3M per minor column) — NOT the naive occupancy ratio (nnz is
    0.11M), because the 16 hybridisation cross hops are
    permutation-sparse but dense-block in this algebra.  The real
    headroom is (a) gather-form cross terms (drops FLOPs to the
    within-half 0.74M) and (b) the block-tridiagonal schedule reading x
    once."""
    cfg, hloc, hrec, dhyb, terms = _plaquette_terms(3)   # Ns=16
    assert cfg.ns == 16
    f = hier.build_hier_factor(16, 8, terms)
    chain = hier.flops_per_minor(f)
    tile_macs = 1483 * 128 * 128          # measured tile count, r2-r4
    assert chain < tile_macs, (chain, tile_macs)
    # within-half-only MACs (cross terms applied as gathers): the
    # fused-kernel FLOP floor
    within = 0
    for i in range(len(f.n_a_vals)):
        if f.ha_ops[i] is not None:
            within += f.ca[i] * f.ca[i] * f.cb[i]
        if f.hb_ops[i] is not None:
            within += f.cb[i] * f.cb[i] * f.ca[i]
    assert within * 5 < tile_macs, (within, tile_macs)


def test_hier_matvec_jnp_matches_np():
    """Device (jittable) block-chain matvec == numpy reference == ELL."""
    import jax
    import jax.numpy as jnp

    cfg, hloc, hrec, dhyb, terms = _plaquette_terms(1)
    ns, n = cfg.ns, 4
    states = np.asarray(fock.sector_states(ns, n), np.int64)
    ell = sector_ham._spin_hop_ell(states, terms)
    h_dense = ell.to_dense().real
    f = hier.build_hier_factor(ns, n, terms)
    dev = hier.device_blocks(f)
    rng = np.random.default_rng(11)
    v = rng.normal(size=(len(states), 2))
    vh = np.empty_like(v)
    vh[f.perm] = v
    fn = jax.jit(lambda x: hier.matvec_hier_jnp(f, dev, x))
    yh = np.asarray(fn(jnp.asarray(vh)))
    np.testing.assert_allclose(yh[f.perm], h_dense @ v, rtol=1e-12,
                               atol=1e-12)
