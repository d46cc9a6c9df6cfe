"""Eigensolvers: thick-restart Lanczos (ARPACK replacement) and plain
Lanczos tridiagonalisation (GF resolvent).

Replaces the reference's external P-ARPACK / SciFortran SF_SP_LINALG layer
(ED_DIAG.f90:150-185; ED_GF_NORMAL.f90:215-220) with JAX-native solvers:

* :func:`lanczos_eigh` — thick-restart Lanczos [Wu & Simon 2000] with full
  (CGS2) reorthogonalisation inside an ``ncv``-dimensional Krylov basis,
  matching ARPACK's ``Neigen/Ncv/tol`` semantics
  (Ncv = lanc_ncv_factor*max(Neigen,lanc_nstates_sector)+lanc_ncv_add,
  ED_DIAG.f90:93-102).  The basis lives on device as one [ncv, dim] array;
  each expansion step is a fixed-shape jitted kernel (masked over the active
  prefix) so there is exactly one compilation per sector shape.
* :func:`lanczos_tridiag` — fixed-step tridiagonalisation without
  reorthogonalisation for continued-fraction Green's functions
  (`lanc_ngfiter` steps), mirroring sp_lanc_tridiag semantics.
* :func:`dense_eigh` — small-sector dense path (ED_DIAG.f90:194-218).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import dispatch as _dispatch


# Operator-as-argument convention: every solver accepts either a legacy
# closure matvec(x) (operator baked into the jitted HLO as constants —
# recompiles per sector AND per bath update) or, preferably, a PURE
# ``apply_fn(op, x)`` plus ``op=`` pytree.  With the pure form the jitted
# kernels are created once per apply_fn (lru-cached factories below) and
# XLA caches one executable per shape bucket, reused across sectors and
# DMFT iterations.

def _as_applier(matvec, op):
    if op is not None:
        return matvec, op, True
    return (lambda _o, *xs: matvec(*xs)), 0, False


def _batch_put(mesh, axis: str = "sector"):
    """Placement function sharding the LEADING (batch) axis of an array
    over ``mesh`` axis ``axis`` — the sector-parallel dispatch lever
    (SURVEY 2.3 item 7: B same-bucket sectors run data-parallel across
    chips; every per-member op is independent, so GSPMD partitions the
    batched kernels with zero communication).  Identity when mesh is
    None."""
    if mesh is None:
        return lambda a: a
    from jax.sharding import NamedSharding, PartitionSpec

    def put(a):
        spec = PartitionSpec(axis, *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    return put


@functools.lru_cache(maxsize=None)
def _basis_init(ncv1: int, dim: int, dtype):
    """Jitted zeros+set-row: EAGER `.at[0].set` copies the whole basis,
    briefly doubling the dominant HBM term at large-sector scale."""
    @jax.jit
    def init(v):
        return jnp.zeros((ncv1, dim), dtype).at[0].set(v.astype(dtype))
    return init


@functools.lru_cache(maxsize=None)
def _basis_restart_pack(ncv1: int, k: int, dtype):
    """Jitted restart reassembly (zeros + two sets fuse into ONE output
    buffer; the eager form allocates three full-basis copies)."""
    @jax.jit
    def pack(nb, last):
        dim = nb.shape[1]
        return jnp.zeros((ncv1, dim), dtype).at[:k].set(nb) \
            .at[k].set(last)
    return pack


# ---------------------------------------------------------------------------
# plain Lanczos tridiagonalisation (no reorth) — GF resolvent kernel
# ---------------------------------------------------------------------------

def lanczos_tridiag(matvec: Callable, v0: jax.Array, niter: int,
                    tol: float = 0.0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Run up to ``niter`` Lanczos steps from (unnormalised) v0.

    Returns (alphas[m], betas[m-1], m) where m ≤ niter is the number of
    completed steps (early-stopped when β underflows, i.e. an invariant
    subspace was found — matches sp_lanc_tridiag behaviour).
    """
    norm0 = float(jnp.linalg.norm(v0))
    if norm0 == 0.0:
        return np.zeros(0), np.zeros(0), 0

    dtype = v0.dtype

    @jax.jit
    def step(carry, _):
        v_prev, v, beta_prev = carry
        w = matvec(v)
        alpha = jnp.real(jnp.vdot(v, w))
        w = w - alpha * v - beta_prev * v_prev
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 0, w / jnp.maximum(beta, 1e-300), w)
        return (v, v_next, beta.astype(dtype)), (alpha, beta)

    v = v0 / norm0
    carry = (jnp.zeros_like(v), v, jnp.asarray(0.0, dtype))
    _, (alphas, betas) = jax.lax.scan(step, carry, None, length=niter)
    alphas = np.asarray(alphas)
    betas = np.asarray(jnp.real(betas))
    # truncate at invariant subspace (β ~ 0)
    thresh = max(tol, 1e-14) * max(1.0, float(np.abs(alphas).max(initial=1.0)))
    m = niter
    for j in range(niter - 1):
        if betas[j] < thresh * 1e-2:
            m = j + 1
            break
    return alphas[:m], betas[:m - 1] if m > 0 else betas[:0], m


def lanczos_tridiag_batched(matvec, v0: jax.Array, niter: int):
    """Batched fixed-step Lanczos tridiagonalisation.

    v0 : [B, dim] unnormalised start vectors (rows).  ``matvec`` maps a
    single [dim] vector.  Returns host arrays (alphas [B, niter],
    betas [B, niter-1], norms0 [B]): the device-side replacement for the
    reference's one-Lanczos-per-injection loop (ED_GF_NORMAL.f90:215-220) —
    all injections into the same target sector run as ONE batched kernel,
    so the H·v becomes an SpMM with B columns.

    Chains are truncated on host at the first vanishing beta (invariant
    subspace), exactly like the serial variant.
    """
    b, dim = v0.shape
    norms0 = jnp.linalg.norm(v0, axis=1)
    dtype = v0.dtype
    mv = jax.vmap(matvec)

    @jax.jit
    def run(v0n):
        def step(carry, _):
            v_prev, v, beta_prev = carry
            w = mv(v)
            alpha = jnp.real(jnp.einsum("bi,bi->b", v.conj(), w))
            w = w - alpha[:, None].astype(dtype) * v \
                - beta_prev[:, None].astype(dtype) * v_prev
            beta = jnp.linalg.norm(w, axis=1)
            v_next = jnp.where((beta > 1e-200)[:, None],
                               w / jnp.maximum(beta, 1e-300)[:, None], 0.0)
            return (v, v_next, beta.astype(dtype)), (alpha, beta)

        carry = (jnp.zeros_like(v0n), v0n, jnp.zeros(b, dtype))
        _, (alphas, betas) = jax.lax.scan(step, carry, None, length=niter)
        return alphas.T, betas.T          # [B, niter]

    v0n = v0 / jnp.maximum(norms0, 1e-300)[:, None]
    alphas, betas = run(v0n)
    _dispatch.tick("gf.tridiag")
    return (np.asarray(alphas), np.asarray(jnp.real(betas))[:, : niter - 1],
            np.asarray(norms0))


@functools.lru_cache(maxsize=None)
def _tridiag_split_run(apply_fn, niter: int, op_batched: bool = False):
    @jax.jit
    def run(op, v0r, v0i):
        mv = ((lambda vr, vi: apply_fn(op, vr, vi)) if op_batched
              else jax.vmap(lambda vr, vi: apply_fn(op, vr, vi)))

        def step(carry, _):
            pr, pi, vr, vi, beta_prev = carry
            wr, wi = mv(vr, vi)
            alpha = jnp.sum(vr * wr + vi * wi, axis=1)     # Re<v|w>
            a = alpha[:, None]
            bp = beta_prev[:, None]
            wr = wr - a * vr - bp * pr
            wi = wi - a * vi - bp * pi
            beta = jnp.sqrt(jnp.sum(wr ** 2 + wi ** 2, axis=1))
            good = (beta > 1e-200)[:, None]
            d = jnp.maximum(beta, 1e-300)[:, None]
            nr = jnp.where(good, wr / d, 0.0)
            ni = jnp.where(good, wi / d, 0.0)
            return (vr, vi, nr, ni, beta), (alpha, beta)

        z = jnp.zeros_like(v0r)
        carry = (z, z, v0r, v0i, jnp.zeros(v0r.shape[0], v0r.dtype))
        _, (alphas, betas) = jax.lax.scan(step, carry, None, length=niter)
        return alphas.T, betas.T

    return run


def lanczos_tridiag_batched_split(matvec_pair, v0: np.ndarray, niter: int,
                                  op=None, dtype=jnp.float64,
                                  op_batched: bool = False):
    """Split-representation batched tridiagonalisation (accelerator path).

    v0 : complex host array [B, dim], OR a ``(v0r, v0i)`` tuple of
    DEVICE plane arrays [B, dim] (split-pair states: normalised on
    device, no host round-trip); ``matvec_pair`` maps one (vr, vi)
    [dim] pair (legacy closure form) or is a pure ``apply(op, vr, vi)``
    with ``op=`` given (kernel shared across sectors/bath updates).
    ``op_batched=True`` marks ``matvec_pair`` as already batched over the
    leading axis (e.g. the large-sector kernels that fold the batch into
    the SpMM width) — no vmap is applied.
    Returns the same host arrays as :func:`lanczos_tridiag_batched`."""
    if isinstance(v0, tuple):
        v0r_d, v0i_d = v0
        norms0_d = jnp.sqrt(jnp.sum(v0r_d * v0r_d, axis=1)
                            + jnp.sum(v0i_d * v0i_d, axis=1))
        sc = jnp.maximum(norms0_d, 1e-300)[:, None]
        v0r = (v0r_d / sc).astype(dtype)
        v0i = (v0i_d / sc).astype(dtype)
        norms0 = np.asarray(norms0_d)
    else:
        v0 = np.asarray(v0)
        norms0 = np.linalg.norm(v0, axis=1)
        scale = np.where(norms0 > 1e-300, norms0, 1.0)
        v0r = jnp.asarray(np.ascontiguousarray(v0.real / scale[:, None]),
                          dtype)
        v0i = jnp.asarray(np.ascontiguousarray(v0.imag / scale[:, None]),
                          dtype)
    apply_fn, opd, cached = _as_applier(matvec_pair, op)
    run = (_tridiag_split_run(apply_fn, niter, op_batched) if cached
           else _tridiag_split_run.__wrapped__(apply_fn, niter,
                                               op_batched))
    alphas, betas = run(opd, v0r, v0i)
    _dispatch.tick("gf.tridiag")
    return (np.asarray(alphas), np.asarray(betas)[:, : niter - 1],
            norms0)


@functools.lru_cache(maxsize=None)
def _tridiag_real_run(apply_fn, niter: int, op_batched: bool = False):
    @jax.jit
    def run(op, v0n):
        mv = ((lambda v: apply_fn(op, v)) if op_batched
              else jax.vmap(lambda v: apply_fn(op, v)))

        def step(carry, _):
            p, v, beta_prev = carry
            w = mv(v)
            alpha = jnp.sum(v * w, axis=1)
            w = w - alpha[:, None] * v - beta_prev[:, None] * p
            beta = jnp.linalg.norm(w, axis=1)
            good = (beta > 1e-200)[:, None]
            nxt = jnp.where(good, w / jnp.maximum(beta, 1e-300)[:, None],
                            0.0)
            return (v, nxt, beta), (alpha, beta)

        carry = (jnp.zeros_like(v0n), v0n,
                 jnp.zeros(v0n.shape[0], v0n.dtype))
        _, (alphas, betas) = jax.lax.scan(step, carry, None, length=niter)
        return alphas.T, betas.T

    return run


def lanczos_tridiag_batched_real(matvec_real, v0: np.ndarray, niter: int,
                                 op=None, dtype=jnp.float64,
                                 op_batched: bool = False):
    """Batched tridiagonalisation for a REAL symmetric operator and REAL
    start vectors: one f64 plane instead of two (3x fewer matmul passes than
    the complex kernel; see ops/split.py real fast path).

    v0 : real host array [B, dim].  ``matvec_real`` maps one [dim] plane
    (legacy closure form), or — preferred — is a pure ``apply(op, x)``
    with the operator passed via ``op=`` (kernel compiled once per shape
    bucket, shared across sectors/bath updates).
    Returns the same host arrays as :func:`lanczos_tridiag_batched`."""
    if isinstance(v0, jax.Array):
        # device-resident batch: normalise on device, no host round-trip
        norms0_d = jnp.linalg.norm(v0, axis=1)
        v0n = (v0 / jnp.maximum(norms0_d, 1e-300)[:, None]).astype(dtype)
        norms0 = np.asarray(norms0_d)
    else:
        v0 = np.asarray(v0)
        norms0 = np.linalg.norm(v0, axis=1)
        scale = np.where(norms0 > 1e-300, norms0, 1.0)
        v0n = jnp.asarray(np.ascontiguousarray(v0 / scale[:, None]), dtype)
    apply_fn, opd, cached = _as_applier(matvec_real, op)
    run = (_tridiag_real_run(apply_fn, niter, op_batched) if cached
           else _tridiag_real_run.__wrapped__(apply_fn, niter, op_batched))
    alphas, betas = run(opd, v0n)
    _dispatch.tick("gf.tridiag")
    return (np.asarray(alphas), np.asarray(betas)[:, : niter - 1], norms0)


@functools.lru_cache(maxsize=None)
def _fused_restart_expand_real(apply_fn):
    """Fused thick-restart round, REAL plane: (optional) basis restart
    from the PREVIOUS round's Ritz rotation + CGS2 expansion k -> ncv,
    in ONE device call returning one packed [ncv+1, ncv] array
    (projection columns + betas).  The split expand/restart/pack form
    issued 3 device calls + 2 blocking transfers per restart (counted by
    utils/dispatch.py); each call pays a fixed dispatch latency."""
    P = jax.lax.Precision.HIGHEST

    @functools.partial(jax.jit, donate_argnums=(1,))
    def step(op, b, s_k, k):
        ncv1 = b.shape[0]
        ncv = ncv1 - 1
        kk = s_k.shape[1]     # STATIC restart size (constant per solve)

        # nb[e] = sum_r s_k[r, e] b[r], only the kk kept Ritz rows,
        # written IN PLACE into the donated basis (rows > kk stay stale
        # and are masked out of the CGS projections until the expansion
        # overwrites them).  Runs UNconditionally — a lax.cond around
        # the carry forces a non-aliased copy of the whole basis (an
        # extra 10 GB at Ns=16/ncv=10); the first round passes the
        # identity rotation instead.
        def body(r, acc):
            return acc + s_k[r][:, None] * b[r][None, :]

        nb = jax.lax.fori_loop(
            0, ncv, body, jnp.zeros((kk, b.shape[1]), b.dtype))
        last = b[ncv]
        b = jax.lax.dynamic_update_slice(b, nb, (0, 0))
        b = b.at[kk].set(jnp.where(k > 0, last, b[kk]))

        def do_step(args):
            b, j = args
            w = apply_fn(op, b[j])
            mask = (jnp.arange(ncv1) <= j)
            c1 = jnp.where(mask, jnp.matmul(b, w, precision=P), 0.0)
            w = w - jnp.matmul(c1, b, precision=P)
            c2 = jnp.where(mask, jnp.matmul(b, w, precision=P), 0.0)
            w = w - jnp.matmul(c2, b, precision=P)
            beta = jnp.linalg.norm(w)
            b = b.at[j + 1].set(w / jnp.maximum(beta, 1e-30))
            return b, (c1 + c2)[: ncv1 - 1], beta

        def skip_step(args):
            b, j = args
            return b, jnp.zeros(ncv1 - 1, b.dtype), \
                jnp.asarray(0.0, b.dtype)

        def sstep(carry, j):
            b, = carry
            b, c, beta = jax.lax.cond(j >= k, do_step, skip_step, (b, j))
            return (b,), (c, beta)

        (b,), (cs, betas) = jax.lax.scan(sstep, (b,), jnp.arange(ncv))
        return b, jnp.concatenate([cs, betas[None, :]], axis=0)

    return step


@functools.lru_cache(maxsize=None)
def _expand_block_real(apply_fn):
    """Whole-restart CGS2 Lanczos expansion, REAL plane (see
    :func:`_expand_block_split`); ``apply_fn(op, x)`` pure.  Returns
    projection columns [ncv, ncv] and betas [ncv].  The basis buffer is
    DONATED: at large-sector scale ((ncv+1) x 1.66e8 f32) keeping input
    and output bases alive doubles the dominant HBM term."""
    P = jax.lax.Precision.HIGHEST

    @functools.partial(jax.jit, donate_argnums=(1,))
    def expand(op, b, k):
        ncv1 = b.shape[0]

        def do_step(args):
            b, j = args
            w = apply_fn(op, b[j])
            mask = (jnp.arange(ncv1) <= j)
            c1 = jnp.where(mask, jnp.matmul(b, w, precision=P), 0.0)
            w = w - jnp.matmul(c1, b, precision=P)
            c2 = jnp.where(mask, jnp.matmul(b, w, precision=P), 0.0)
            w = w - jnp.matmul(c2, b, precision=P)
            beta = jnp.linalg.norm(w)
            b = b.at[j + 1].set(w / jnp.maximum(beta, 1e-30))
            return b, (c1 + c2)[: ncv1 - 1], beta

        def skip_step(args):
            b, j = args
            return b, jnp.zeros(ncv1 - 1, b.dtype), \
                jnp.asarray(0.0, b.dtype)

        def step(carry, j):
            b, = carry
            b, c, beta = jax.lax.cond(j >= k, do_step, skip_step, (b, j))
            return (b,), (c, beta)

        (b,), (cs, betas) = jax.lax.scan(step, (b,), jnp.arange(ncv1 - 1))
        return b, cs, betas

    return expand



@jax.jit
def _restart_real(b, s):
    # out[e] = sum_k s[k, e] * b[k], accumulated row-wise: the direct
    # [k, ncv] x [ncv, dim] matmul can lower through an O(ncv^2 * dim)
    # intermediate (42 GB at dim 1.66e8)
    ncv, ke = s.shape
    dim = b.shape[1]

    def body(k, acc):
        return acc + s[k][:, None] * b[k][None, :]

    out_dtype = jnp.result_type(b.dtype, s.dtype)
    return jax.lax.fori_loop(0, ncv, body,
                             jnp.zeros((ke, dim), out_dtype))


@jax.jit
def _restart_split(br, bi, sr, si):
    ncv, ke = sr.shape
    dim = br.shape[1]

    def body(k, accs):
        nr, ni = accs
        nr = nr + sr[k][:, None] * br[k][None, :] \
            - si[k][:, None] * bi[k][None, :]
        ni = ni + sr[k][:, None] * bi[k][None, :] \
            + si[k][:, None] * br[k][None, :]
        return nr, ni

    z = jnp.zeros((ke, dim), jnp.result_type(br.dtype, sr.dtype))
    return jax.lax.fori_loop(0, ncv, body, (z, z))



def _conv_ok(conv, rel, eps: float, dim: int) -> bool:
    """Converged verdict for a halted thick-restart sweep: either every
    wanted residual met ``tol``, or the worst one is at/below 1e-9
    relative (comfortably inside GF-grade vector quality — a 1e-9
    residual perturbs Sigma by ~4e-6 at beta=1000) or at the dtype
    residual floor ~ eps*sqrt(dim).  ARPACK tol=0 semantics: a solve
    that bottoms out near machine precision IS converged; only a stall
    well above that is a degraded result worth warning about
    (ADVICE r3)."""
    floor = max(1e-9, 100.0 * eps * np.sqrt(max(dim, 1)))
    return bool(conv.all()) or float(np.max(rel)) <= floor


class _StallGuard:
    """Stops a thick-restart sweep when the worst wanted relative
    residual has reached its precision floor: the Lanczos residual
    estimate bottoms out near dtype-eps * ||H|| * O(sqrt(dim)) and every
    further restart is pure waste.  Callers with ARPACK tol=0 semantics
    (cfg tolerances below the floor) previously ground to maxiter —
    hundreds of device round trips per sector.

    The guard only ARMS below ``arm`` (1e-3 relative): thick restart
    legitimately plateaus for several sweeps early on while interior
    clusters resolve, and aborting there hands garbage vectors to the
    refine stage (observed: 0.29 relative residual shipped downstream).
    Near the floor a >=1%-per-sweep improvement test over ``limit``
    consecutive sweeps separates floor noise from slow convergence."""

    def __init__(self, limit: int = 4, arm: float = 1e-3):
        self.best = np.inf
        self.n = 0
        self.limit = limit
        self.arm = arm

    def stalled(self, cur: float) -> bool:
        if cur < 0.99 * self.best:
            self.best = cur
            self.n = 0
        elif self.best < self.arm:
            self.n += 1
        return self.n >= self.limit


def lanczos_eigh_real(matvec_real, dim: int, neigen: int, ncv: int,
                      maxiter: int = 512, tol: float = 1e-14,
                      v0: Optional[np.ndarray] = None,
                      seed: int = 8527, dtype=jnp.float64,
                      op=None, device_vectors: bool = False,
                      op16=None) -> EighResult:
    """Thick-restart Lanczos for a REAL symmetric operator with a real
    start vector: the whole Krylov iteration stays real (eigenvectors of a
    real symmetric H can always be chosen real), halving memory and
    running 3x fewer matmul passes than the split-complex path.  Returned
    eigenvectors are real f64 host arrays [neigen, dim].

    ``dtype=jnp.float32`` runs the ENTIRE device iteration (basis, matvec,
    CGS2) in f32 — required for the mixed-precision scheme; leaving the
    basis f64 would silently promote the f32 matvec back to f64.

    ``op16`` (optional): a bf16-tile build of the same operator used as
    a COARSE first stage — restarts run with bf16 tensor-core MACs (~2x the f32
    rate) until the worst wanted residual drops below ~3e-3 (bf16
    resolution), then the loop switches to ``op``.  Most matvecs of a
    cold solve happen above that threshold, and downstream accuracy is
    certified by the f64 refine regardless."""
    neigen = min(neigen, dim)
    ncv = int(min(max(ncv, neigen + 2), dim))
    eps = float(np.finfo(np.dtype(dtype).name).eps)
    tol = max(tol, eps)

    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.normal(size=dim)
    v0 = np.real(np.asarray(v0))
    v0 = v0 / np.linalg.norm(v0)

    basis = _basis_init(ncv + 1, dim, dtype)(jnp.asarray(v0, dtype))
    t_proj = np.zeros((ncv, ncv))
    apply_fn, opd, cached = _as_applier(matvec_real, op)
    # fused single-call restart rounds for small/medium bases (the
    # dispatch-latency regime of the DMFT loop); GIANT bases keep the
    # classic split calls — the fused form's in-jit rotation defeats
    # the donated-basis aliasing and duplicates the dominant HBM term
    # (measured: +10 GB at Ns=16/ncv=10)
    fused_mode = (ncv + 1) * dim * np.dtype(
        np.dtype(dtype).name).itemsize <= (1 << 30)
    if fused_mode:
        fused = (_fused_restart_expand_real(apply_fn) if cached
                 else _fused_restart_expand_real.__wrapped__(apply_fn))
    else:
        expand = (_expand_block_real(apply_fn) if cached
                  else _expand_block_real.__wrapped__(apply_fn))
    restart_basis = _restart_real

    k = 0
    nmv = 0
    stall = _StallGuard()
    coarse = op16 is not None
    kfix = min(neigen + max(neigen, (ncv - neigen) // 2), ncv - 1)
    s_dev = jnp.asarray(np.eye(ncv, kfix), dtype) if fused_mode else None
    s_host = None
    while True:
        if fused_mode:
            # ONE device call per restart round: rotate-restart (the
            # kept Ritz columns from the previous round) + CGS2
            # expansion, one packed transfer back (utils/dispatch.py
            # counts the win)
            basis, packed = fused(op16 if coarse else opd, basis,
                                  s_dev, k)
            _dispatch.tick("lanczos.fused_round")
            arr = np.asarray(packed)
            cs = arr[:ncv]
            betas_np = arr[ncv]
        else:
            if k > 0:
                # classic aliasing-safe restart: rotate + pack in
                # separate calls, old basis released in between (the
                # peak-HBM pattern of the r4 large-sector solve)
                sj = jnp.asarray(np.ascontiguousarray(s_host[:, :k]),
                                 dtype)
                nb = restart_basis(basis, sj)
                last_row = basis[ncv]
                basis = None
                _dispatch.tick("lanczos.restart", 2)
                basis = _basis_restart_pack(ncv + 1, k, dtype)(
                    nb, last_row)
                del nb, last_row
            basis, cs_d, betas_d = expand(op16 if coarse else opd,
                                          basis, k)
            _dispatch.tick("lanczos.expand")
            cs = np.asarray(cs_d)
            betas_np = np.asarray(betas_d)
        for j in range(k, ncv):
            t_proj[: j + 1, j] = cs[j][: j + 1]
            t_proj[j, : j + 1] = cs[j][: j + 1]
            beta_f = float(betas_np[j])
            if j + 1 < ncv:
                t_proj[j + 1, j] = beta_f
                t_proj[j, j + 1] = beta_f
            nmv += 1
        last_beta = beta_f

        theta, s = np.linalg.eigh(t_proj)
        resid = np.abs(last_beta * s[-1, :])
        rel = resid[:neigen] / np.maximum(np.abs(theta[:neigen]), 1.0)
        conv = rel <= tol
        if coarse and (float(rel.max()) < 3e-3
                       or stall.stalled(float(rel.max()))
                       or nmv >= maxiter // 2):
            # bf16 resolution reached: hand the basis to the f32 stage
            coarse = False
            op16 = None                       # free the coarse tiles
            stall = _StallGuard()
        if coarse:
            # bf16-grade Ritz data is never acceptable, even at loose
            # caller tolerances (> 3e-3): acceptance only after the
            # coarse stage has handed off (ADVICE r4)
            conv = np.zeros_like(conv)
        if bool(conv.all()) or nmv >= maxiter or ncv >= dim \
                or (not coarse and stall.stalled(float(rel.max()))):
            sj = jnp.asarray(np.ascontiguousarray(s[:, :neigen]))
            if device_vectors:
                # large sectors: keep the Ritz vectors DEVICE-resident
                # (no O(neigen*dim) host round-trip; the reference keeps
                # eigenvectors distributed, ED_EIGENSPACE.f90:499-569)
                vecs_d = restart_basis(basis, sj)
                nrm_d = jnp.linalg.norm(vecs_d, axis=1, keepdims=True)
                vecs_d = (vecs_d / jnp.maximum(nrm_d, 1e-300)) \
                    .astype(jnp.float64)
                return EighResult(theta[:neigen].copy(), vecs_d, nmv,
                                  _conv_ok(conv, rel, eps, dim))
            vecs = np.asarray(restart_basis(basis, sj))
            nrm = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = vecs / np.maximum(nrm, 1e-300)
            return EighResult(theta[:neigen].copy(), vecs, nmv,
                              _conv_ok(conv, rel, eps, dim))

        k = kfix
        # the restart happens ON DEVICE at the start of the next round
        if fused_mode:
            s_dev = jnp.asarray(np.ascontiguousarray(s[:, :kfix]),
                                dtype)
        else:
            s_host = s
        t_proj[:] = 0.0
        t_proj[:k, :k] = np.diag(theta[:k])
        b_row = last_beta * s[-1, :k]
        t_proj[k, :k] = b_row
        t_proj[:k, k] = b_row


@functools.lru_cache(maxsize=None)
def _expand_real_batched(apply_fn):
    P = jax.lax.Precision.HIGHEST

    @jax.jit
    def expand(op, bas, k):
        ncv1 = bas.shape[1]
        nb = bas.shape[0]

        def do_step(args):
            bb, j = args
            w = apply_fn(op, bb[:, j])                      # [B, dim]
            mask = (jnp.arange(ncv1) <= j)
            c1 = jnp.where(mask[None], jnp.einsum(
                "bnd,bd->bn", bb, w, precision=P), 0.0)
            w = w - jnp.einsum("bn,bnd->bd", c1, bb, precision=P)
            c2 = jnp.where(mask[None], jnp.einsum(
                "bnd,bd->bn", bb, w, precision=P), 0.0)
            w = w - jnp.einsum("bn,bnd->bd", c2, bb, precision=P)
            beta = jnp.linalg.norm(w, axis=1)               # [B]
            bb = bb.at[:, j + 1].set(
                w / jnp.maximum(beta, 1e-30)[:, None])
            return bb, (c1 + c2)[:, : ncv1 - 1], beta

        def skip_step(args):
            bb, j = args
            return bb, jnp.zeros((nb, ncv1 - 1), bb.dtype), \
                jnp.zeros(nb, bb.dtype)

        def step(carry, j):
            bb, = carry
            bb, c, beta = jax.lax.cond(j >= k, do_step, skip_step,
                                       (bb, j))
            return (bb,), (c, beta)

        (bas,), (cs, betas) = jax.lax.scan(step, (bas,),
                                           jnp.arange(ncv1 - 1))
        return bas, cs, betas        # cs [ncv, B, ncv], betas [ncv, B]

    return expand


@functools.lru_cache(maxsize=None)
def _fused_restart_expand_real_batched(apply_fn):
    """Batched twin of :func:`_fused_restart_expand_real`: restart +
    CGS2 expansion in one device call, one packed transfer
    ([ncv, B, ncv+1]: projection columns + beta in the last slot)."""
    P = jax.lax.Precision.HIGHEST

    @functools.partial(jax.jit, donate_argnums=(1,))
    def step(op, bas, s_k, k):
        nb = bas.shape[0]
        ncv1 = bas.shape[1]
        ncv = ncv1 - 1
        kk = s_k.shape[2]     # STATIC restart size

        # unconditional in-place rotation (identity on round 1): a
        # lax.cond around the carry copies the whole basis stack
        rot = jnp.einsum("bnk,bnd->bkd", s_k, bas[:, :ncv],
                         precision=P)            # [B, kk, dim]
        last = bas[:, ncv]
        bas = jax.lax.dynamic_update_slice(bas, rot, (0, 0, 0))
        bas = bas.at[:, kk].set(jnp.where(k > 0, last, bas[:, kk]))

        def do_step(args):
            bb, j = args
            w = apply_fn(op, bb[:, j])
            mask = (jnp.arange(ncv1) <= j)
            c1 = jnp.where(mask[None], jnp.einsum(
                "bnd,bd->bn", bb, w, precision=P), 0.0)
            w = w - jnp.einsum("bn,bnd->bd", c1, bb, precision=P)
            c2 = jnp.where(mask[None], jnp.einsum(
                "bnd,bd->bn", bb, w, precision=P), 0.0)
            w = w - jnp.einsum("bn,bnd->bd", c2, bb, precision=P)
            beta = jnp.linalg.norm(w, axis=1)
            bb = bb.at[:, j + 1].set(
                w / jnp.maximum(beta, 1e-30)[:, None])
            return bb, (c1 + c2)[:, : ncv1 - 1], beta

        def skip_step(args):
            bb, j = args
            return bb, jnp.zeros((nb, ncv1 - 1), bb.dtype), \
                jnp.zeros(nb, bb.dtype)

        def sstep(carry, j):
            bb, = carry
            bb, c, beta = jax.lax.cond(j >= k, do_step, skip_step,
                                       (bb, j))
            return (bb,), (c, beta)

        (bas,), (cs, betas) = jax.lax.scan(sstep, (bas,),
                                           jnp.arange(ncv))
        return bas, jnp.concatenate([cs, betas[:, :, None]], axis=2)

    return step


@jax.jit
def _restart_basis_batched(bas, s):
    # s [B, ncv, k]: new rows = s^T @ basis rows, per batch member
    ncv = s.shape[1]
    return jnp.einsum("bnk,bnd->bkd", s, bas[:, :ncv],
                      precision=jax.lax.Precision.HIGHEST)


def lanczos_eigh_real_batched(matvec_batched, nbatch: int, dim: int,
                              neigen: int, ncv: int, maxiter: int = 512,
                              tol: float = 1e-14,
                              v0: Optional[np.ndarray] = None,
                              seed: int = 8527, op=None,
                              dtype=jnp.float64, batch_mesh=None):
    """Batched thick-restart Lanczos: ``nbatch`` independent REAL symmetric
    operators (one batched matvec [B, dim] -> [B, dim]) solved in ONE
    device stream with a SHARED restart schedule.

    This is the sector-parallel dispatch the reference lacks
    (ED_DIAG.f90:78 solves sectors strictly serially): B same-bucket
    sectors amortise every kernel launch / host-device round trip — the
    dominant cost for small sectors.  Each batch member
    converges independently; the sweep stops when ALL have (extra
    iterations on already-converged members are masked-cost device work).

    Returns a list of ``nbatch`` :class:`EighResult`.
    """
    b = nbatch
    neigen = min(neigen, dim)
    ncv = int(min(max(ncv, neigen + 2), dim))
    eps = float(np.finfo(np.dtype(dtype).name).eps)
    tol = max(tol, eps)

    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.normal(size=(b, dim))
    v0 = np.real(np.asarray(v0))
    v0 = v0 / np.linalg.norm(v0, axis=1, keepdims=True)

    # sector-parallel: basis [B, ncv+1, dim] sharded on the batch axis;
    # with the op stack sharded the same way GSPMD keeps every restart
    # device-local (the caller device_puts the op, diag.py)
    bput = _batch_put(batch_mesh)
    basis = bput(jnp.zeros((b, ncv + 1, dim), dtype).at[:, 0].set(
        jnp.asarray(v0, dtype)))
    t_proj = np.zeros((b, ncv, ncv))
    apply_fn, opd, cached = _as_applier(matvec_batched, op)
    fused = (_fused_restart_expand_real_batched(apply_fn) if cached
             else _fused_restart_expand_real_batched.__wrapped__(apply_fn))
    restart_basis = _restart_basis_batched

    k = 0
    nmv = 0
    stall = _StallGuard()
    kfix = min(neigen + max(neigen, (ncv - neigen) // 2), ncv - 1)
    s_dev = bput(jnp.asarray(
        np.broadcast_to(np.eye(ncv, kfix), (b, ncv, kfix)), dtype))
    while True:
        basis, packed = fused(opd, basis, s_dev, k)
        _dispatch.tick("lanczos.fused_round")
        arr = np.asarray(packed)              # [ncv, B, ncv+1]
        cs = arr[..., :ncv]                   # [ncv, B, ncv]
        betas_np = arr[..., ncv]              # [ncv, B]
        for j in range(k, ncv):
            t_proj[:, : j + 1, j] = cs[j][:, : j + 1]
            t_proj[:, j, : j + 1] = cs[j][:, : j + 1]
            if j + 1 < ncv:
                t_proj[:, j + 1, j] = betas_np[j]
                t_proj[:, j, j + 1] = betas_np[j]
            nmv += 1
        last_beta = betas_np[ncv - 1]         # [B]

        theta, s = np.linalg.eigh(t_proj)     # [B, ncv], [B, ncv, ncv]
        resid = np.abs(last_beta[:, None] * s[:, -1, :])   # [B, ncv]
        rel = resid[:, :neigen] \
            / np.maximum(np.abs(theta[:, :neigen]), 1.0)
        conv = np.all(rel <= tol, axis=1)
        if bool(conv.all()) or nmv >= maxiter or ncv >= dim \
                or stall.stalled(float(rel.max())):
            import os
            if os.environ.get("CDMFT_DEBUG_REFINE"):
                print(f"# lanczos[bR {np.dtype(np.dtype(dtype).name)}] "
                      f"dim={dim} B={b} nmv={nmv} "
                      f"worst_rel={rel.max():.2e} "
                      f"conv={conv.tolist()}", flush=True)
            sj = jnp.asarray(np.ascontiguousarray(s[:, :, :neigen]))
            vecs = np.asarray(restart_basis(basis, sj))    # [B, ne, dim]
            nrm = np.linalg.norm(vecs, axis=2, keepdims=True)
            vecs = vecs / np.maximum(nrm, 1e-300)
            return [EighResult(
                theta[i, :neigen].copy(), vecs[i], nmv,
                _conv_ok(conv[i:i + 1], rel[i], eps, dim))
                for i in range(b)]

        k = kfix
        # restart runs on device inside the next fused round
        s_dev = bput(jnp.asarray(
            np.ascontiguousarray(s[:, :, :kfix]), dtype))
        t_proj[:] = 0.0
        idx = np.arange(k)
        t_proj[:, idx, idx] = theta[:, :k]
        b_row = last_beta[:, None] * s[:, -1, :k]          # [B, k]
        t_proj[:, k, :k] = b_row
        t_proj[:, :k, k] = b_row


@functools.lru_cache(maxsize=None)
def _expand_split_batched(apply_fn):
    P = jax.lax.Precision.HIGHEST

    @jax.jit
    def expand(op, br, bi, k):
        ncv1 = br.shape[1]
        nb = br.shape[0]

        def do_step(args):
            br, bi, j = args
            wr, wi = apply_fn(op, br[:, j], bi[:, j])
            mask = (jnp.arange(ncv1) <= j)[None]

            def proj(wr, wi):
                cr = jnp.where(mask, jnp.einsum(
                    "bnd,bd->bn", br, wr, precision=P) + jnp.einsum(
                    "bnd,bd->bn", bi, wi, precision=P), 0.0)
                ci = jnp.where(mask, jnp.einsum(
                    "bnd,bd->bn", br, wi, precision=P) - jnp.einsum(
                    "bnd,bd->bn", bi, wr, precision=P), 0.0)
                return cr, ci

            c1r, c1i = proj(wr, wi)
            wr = wr - (jnp.einsum("bn,bnd->bd", c1r, br, precision=P)
                       - jnp.einsum("bn,bnd->bd", c1i, bi, precision=P))
            wi = wi - (jnp.einsum("bn,bnd->bd", c1r, bi, precision=P)
                       + jnp.einsum("bn,bnd->bd", c1i, br, precision=P))
            c2r, c2i = proj(wr, wi)
            wr = wr - (jnp.einsum("bn,bnd->bd", c2r, br, precision=P)
                       - jnp.einsum("bn,bnd->bd", c2i, bi, precision=P))
            wi = wi - (jnp.einsum("bn,bnd->bd", c2r, bi, precision=P)
                       + jnp.einsum("bn,bnd->bd", c2i, br, precision=P))
            beta = jnp.sqrt(jnp.sum(wr ** 2 + wi ** 2, axis=1))
            d = jnp.maximum(beta, 1e-30)[:, None]
            br = br.at[:, j + 1].set(wr / d)
            bi = bi.at[:, j + 1].set(wi / d)
            return br, bi, (c1r + c2r)[:, : ncv1 - 1], \
                (c1i + c2i)[:, : ncv1 - 1], beta

        def skip_step(args):
            br, bi, j = args
            z = jnp.zeros((nb, ncv1 - 1), br.dtype)
            return br, bi, z, z, jnp.zeros(nb, br.dtype)

        def step(carry, j):
            br, bi = carry
            br, bi, cr, ci, beta = jax.lax.cond(
                j >= k, do_step, skip_step, (br, bi, j))
            return (br, bi), (cr, ci, beta)

        (br, bi), (crs, cis, betas) = jax.lax.scan(
            step, (br, bi), jnp.arange(ncv1 - 1))
        return br, bi, crs, cis, betas

    return expand


@functools.lru_cache(maxsize=None)
def _fused_restart_expand_split_batched(apply_fn):
    """Batched split-pair fused restart round: one device call, one
    packed [ncv, B, 2*ncv+1] transfer (re/im columns + betas)."""
    P = jax.lax.Precision.HIGHEST
    inner = _expand_split_batched.__wrapped__(apply_fn)

    @functools.partial(jax.jit, donate_argnums=(1, 2))
    def step(op, br, bi, sr_k, si_k, k):
        ncv1 = br.shape[1]
        ncv = ncv1 - 1
        kk = sr_k.shape[2]    # STATIC restart size (in-place rotation)

        # unconditional in-place rotation (identity on round 1)
        vr, vi = br[:, :ncv], bi[:, :ncv]
        nr = jnp.einsum("bnk,bnd->bkd", sr_k, vr, precision=P) \
            - jnp.einsum("bnk,bnd->bkd", si_k, vi, precision=P)
        ni = jnp.einsum("bnk,bnd->bkd", sr_k, vi, precision=P) \
            + jnp.einsum("bnk,bnd->bkd", si_k, vr, precision=P)
        lr, li = br[:, ncv], bi[:, ncv]
        br = jax.lax.dynamic_update_slice(br, nr, (0, 0, 0))
        br = br.at[:, kk].set(jnp.where(k > 0, lr, br[:, kk]))
        bi = jax.lax.dynamic_update_slice(bi, ni, (0, 0, 0))
        bi = bi.at[:, kk].set(jnp.where(k > 0, li, bi[:, kk]))
        br, bi, crs, cis, betas = inner(op, br, bi, k)
        return br, bi, jnp.concatenate(
            [crs, cis, betas[:, :, None]], axis=2)

    return step


@jax.jit
def _restart_basis_split_batched(br, bi, sr, si):
    P = jax.lax.Precision.HIGHEST
    ncv = sr.shape[1]
    vr, vi = br[:, :ncv], bi[:, :ncv]
    nr = jnp.einsum("bnk,bnd->bkd", sr, vr, precision=P) \
        - jnp.einsum("bnk,bnd->bkd", si, vi, precision=P)
    ni = jnp.einsum("bnk,bnd->bkd", sr, vi, precision=P) \
        + jnp.einsum("bnk,bnd->bkd", si, vr, precision=P)
    return nr, ni


def lanczos_eigh_split_batched(matvec_pair_batched, nbatch: int, dim: int,
                               neigen: int, ncv: int, maxiter: int = 512,
                               tol: float = 1e-14,
                               v0: Optional[np.ndarray] = None,
                               seed: int = 8527, op=None,
                               dtype=jnp.float64, batch_mesh=None):
    """Batched thick-restart Lanczos on the split-pair representation:
    the complex-sector twin of :func:`lanczos_eigh_real_batched`
    (``matvec_pair_batched`` maps (xr, xi) [B, dim] pairs).  ``v0`` is a
    complex host array [B, dim] (padded — zeros in decoupled padding).
    Returns a list of ``nbatch`` :class:`EighResult` with complex
    eigenvector rows."""
    b = nbatch
    neigen = min(neigen, dim)
    ncv = int(min(max(ncv, neigen + 2), dim))
    eps = float(np.finfo(np.dtype(dtype).name).eps)
    tol = max(tol, eps)

    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.normal(size=(b, dim)) + 1j * rng.normal(size=(b, dim))
    v0 = np.asarray(v0, np.complex128)
    v0 = v0 / np.linalg.norm(v0, axis=1, keepdims=True)

    bput = _batch_put(batch_mesh)
    br = bput(jnp.zeros((b, ncv + 1, dim), dtype).at[:, 0].set(
        jnp.asarray(np.ascontiguousarray(v0.real), dtype)))
    bi = bput(jnp.zeros((b, ncv + 1, dim), dtype).at[:, 0].set(
        jnp.asarray(np.ascontiguousarray(v0.imag), dtype)))
    t_proj = np.zeros((b, ncv, ncv), np.complex128)
    apply_fn, opd, cached = _as_applier(matvec_pair_batched, op)
    fused = (_fused_restart_expand_split_batched(apply_fn) if cached
             else
             _fused_restart_expand_split_batched.__wrapped__(apply_fn))
    restart_basis = _restart_basis_split_batched

    k = 0
    nmv = 0
    stall = _StallGuard()
    kfix = min(neigen + max(neigen, (ncv - neigen) // 2), ncv - 1)
    sr_dev = bput(jnp.asarray(
        np.broadcast_to(np.eye(ncv, kfix), (b, ncv, kfix)), dtype))
    si_dev = bput(jnp.zeros((b, ncv, kfix), dtype))
    while True:
        br, bi, packed = fused(opd, br, bi, sr_dev, si_dev, k)
        _dispatch.tick("lanczos.fused_round")
        arr = np.asarray(packed)               # [ncv, B, 2*ncv+1]
        crs = arr[..., :ncv]                   # [ncv, B, ncv]
        cis = arr[..., ncv:2 * ncv]
        betas_np = arr[..., 2 * ncv]           # [ncv, B]
        for j in range(k, ncv):
            col = crs[j] + 1j * cis[j]         # [B, ncv]
            t_proj[:, : j + 1, j] = col[:, : j + 1]
            t_proj[:, j, : j + 1] = col[:, : j + 1].conj()
            if j + 1 < ncv:
                t_proj[:, j + 1, j] = betas_np[j]
                t_proj[:, j, j + 1] = betas_np[j]
            nmv += 1
        last_beta = betas_np[ncv - 1]          # [B]

        theta, s = np.linalg.eigh(t_proj)      # [B, ncv], [B, ncv, ncv]
        resid = np.abs(last_beta[:, None] * s[:, -1, :])
        rel = resid[:, :neigen] \
            / np.maximum(np.abs(theta[:, :neigen]), 1.0)
        conv = np.all(rel <= tol, axis=1)
        if bool(conv.all()) or nmv >= maxiter or ncv >= dim \
                or stall.stalled(float(rel.max())):
            import os
            if os.environ.get("CDMFT_DEBUG_REFINE"):
                print(f"# lanczos[bS {np.dtype(np.dtype(dtype).name)}] "
                      f"dim={dim} B={b} nmv={nmv} "
                      f"worst_rel={rel.max():.2e} "
                      f"conv={conv.tolist()}", flush=True)
            sj = s[:, :, :neigen]
            sr = jnp.asarray(np.ascontiguousarray(sj.real))
            si = jnp.asarray(np.ascontiguousarray(sj.imag))
            nr, ni = restart_basis(br, bi, sr, si)
            vecs = np.asarray(nr) + 1j * np.asarray(ni)   # [B, ne, dim]
            nrm = np.linalg.norm(vecs, axis=2, keepdims=True)
            vecs = vecs / np.maximum(nrm, 1e-300)
            return [EighResult(
                theta[i, :neigen].copy(), vecs[i], nmv,
                _conv_ok(conv[i:i + 1], rel[i], eps, dim))
                for i in range(b)]

        k = kfix
        # restart runs on device inside the next fused round
        sk = s[:, :, :kfix]
        sr_dev = bput(jnp.asarray(np.ascontiguousarray(sk.real), dtype))
        si_dev = bput(jnp.asarray(np.ascontiguousarray(sk.imag), dtype))
        t_proj[:] = 0.0
        idx = np.arange(k)
        t_proj[:, idx, idx] = theta[:, :k]
        b_row = last_beta[:, None] * s[:, -1, :k].conj()
        t_proj[:, k, :k] = b_row
        t_proj[:, :k, k] = b_row.conj()


def _orth_expand_block(qi, block, rng):
    """Orthonormalise ``block`` [dim, m] against orthonormal ``qi``
    [dim, k] (CGS2 + QR).  Near-dependent columns — e.g. the residual
    block of an already-converged member — are replaced by random
    directions (QR's arbitrary completion columns are NOT orthogonal to
    ``qi``, which would corrupt the Rayleigh quotient)."""
    for _ in range(2):
        block = block - qi @ (qi.conj().T @ block)
    qb, rr = np.linalg.qr(block)
    d = np.abs(np.diag(rr))
    scale = d.max() if d.size else 0.0
    bad = d <= max(scale, 1e-300) * 1e-10
    if bad.any():
        n = qi.shape[0]
        for j in np.nonzero(bad)[0]:
            v = rng.normal(size=n)
            if np.iscomplexobj(qb):
                v = v + 1j * rng.normal(size=n)
            qb[:, j] = v / np.linalg.norm(v)
        for _ in range(2):
            qb = qb - qi @ (qi.conj().T @ qb)
        qb, _ = np.linalg.qr(qb)
    return qb


def _refine_loop_host(hcols, q, neigen: int, rtol, max_expand: int,
                      dim: int, complex_: bool):
    """Shared Rayleigh-Ritz + residual-block subspace expansion loop.

    ``q`` [dim, k0] orthonormal start basis, ``hcols(cols) -> H @ cols``.
    Each expansion appends the orthonormalised residual block of the
    ``neigen`` wanted Ritz pairs (block Jacobi-Davidson without
    preconditioner == block-Krylov growth): with f32-quality starting
    vectors each round gains ~the f32 residual factor, reaching f64
    targets in 1-3 extra rounds of ``neigen`` matvecs — orders of
    magnitude cheaper than the full f64 thick-restart fallback it
    replaces for near-degenerate members."""
    w = hcols(q)
    theta = new_vecs = wmix = resid = None
    for it in range(max_expand + 1):
        hk = q.conj().T @ w if complex_ else q.T @ w
        hk = 0.5 * (hk + hk.conj().T)
        theta, s = np.linalg.eigh(hk)
        theta = theta.real
        new_vecs = q @ s                               # [dim, k]
        wmix = w @ s
        resid = np.linalg.norm(wmix - new_vecs * theta[None, :], axis=0)
        done = (rtol is None or np.all(
            resid[:neigen] <= rtol * np.maximum(np.abs(theta[:neigen]),
                                                1.0)))
        if done or it == max_expand or q.shape[1] + neigen > min(dim, 96):
            break
        r = wmix[:, :neigen] - new_vecs[:, :neigen] * theta[None, :neigen]
        qn = _orth_expand_block(q, r, np.random.default_rng(8527 + it))
        q = np.concatenate([q, qn], axis=1)
        w = np.concatenate([w, hcols(qn)], axis=1)
    return theta, new_vecs, resid


def rayleigh_refine_real(matvec_real64, vecs: np.ndarray, neigen: int,
                         rtol=None, max_expand: int = 2):
    """Real-plane variant of :func:`rayleigh_refine` (real symmetric H,
    real approximate eigenbasis).  When ``rtol`` is given the subspace is
    expanded with residual blocks until the wanted residuals meet
    ``rtol*max(|theta|,1)`` (or ``max_expand`` rounds)."""
    k, dim = np.real(vecs).shape
    q, _ = np.linalg.qr(np.real(vecs).T)

    def hcols(cols):
        out = np.empty_like(cols)
        for j in range(cols.shape[1]):
            out[:, j] = np.asarray(matvec_real64(jnp.asarray(
                np.ascontiguousarray(cols[:, j]))))
        return out

    theta, new_vecs, resid = _refine_loop_host(
        hcols, q, neigen, rtol, max_expand, dim, complex_=False)
    return theta[:neigen], new_vecs.T[:neigen], resid[:neigen]


@functools.partial(jax.jit, static_argnames=("nch",))
def _dot_chunked_jit(a, b, nch: int):
    n = a.shape[0]
    chunk = n // nch

    def body(i, acc):
        sa = jax.lax.dynamic_slice(a, (i * chunk,), (chunk,))
        sb = jax.lax.dynamic_slice(b, (i * chunk,), (chunk,))
        return acc + jnp.sum(sa * sb)

    return jax.lax.fori_loop(0, nch, body,
                             jnp.zeros((), jnp.result_type(a, b)))


def _dot_chunked(a, b, target: int = 1 << 23):
    """<a, b> for real device vectors, reduced in chunks: whole-row f64
    reductions can materialise O(8*dim) temps."""
    n = a.shape[0]
    nch = 1
    while n // nch > target and n % (nch * 2) == 0:
        nch *= 2
    return _dot_chunked_jit(a, b, nch)


@functools.partial(jax.jit, static_argnames=("nch",))
def _gram_chunked_jit(a, b, nch: int):
    n = a.shape[1]
    chunk = n // nch

    def body(i, acc):
        sa = jax.lax.dynamic_slice(a, (0, i * chunk), (a.shape[0], chunk))
        sb = jax.lax.dynamic_slice(b, (0, i * chunk), (b.shape[0], chunk))
        # elementwise product + sum: exact f64 on every backend
        return acc + jnp.sum(sa[:, None, :] * sb[None, :, :], axis=-1)

    return jax.lax.fori_loop(
        0, nch, body,
        jnp.zeros((a.shape[0], b.shape[0]), jnp.result_type(a, b)))


def _gram_chunked(a, b):
    """[k, dim] x [l, dim] -> [k, l] row-Gram for device rows, reduced in
    dim-chunks: an emulated f64 dot can materialise the FULL
    [planes, k, l, d] product tensor when contracting the minor axis
    (reproduced: 3.4 GB at k=l=10, d=1e6 — the round-4 DMFT-bench OOM),
    so the per-chunk temp is bounded at ~2^23 f32 elements per plane."""
    n = a.shape[1]
    target = max(1 << 10, (1 << 21) // max(a.shape[0] * b.shape[0], 1))
    nch = 1
    while n // nch > target and n % (nch * 2) == 0:
        nch *= 2
    return _gram_chunked_jit(a, b, nch)


def _gram_pair_chunked(ar, ai, br, bi):
    """Hermitian row-Gram <a_k|b_l> on split (re, im) planes -> host
    complex [k, l]."""
    re = np.asarray(_gram_chunked(ar, br)) + np.asarray(_gram_chunked(ai, bi))
    im = np.asarray(_gram_chunked(ar, bi)) - np.asarray(_gram_chunked(ai, br))
    return re + 1j * im


def _refine_k_cap(dim: int, k0: int, ne: int, planes: int = 1) -> int:
    """Subspace-size cap for the single-sector device-resident refines:
    q + w are [k, dim] f64 each (x planes).  By refine time the Krylov
    ops are freed (lanczos_eigh_mixed*), so half the device memory can
    go to the expansion bases — at the Ns=16 flagship (1.34 GB per f64
    plane) that buys the 1-2 expansion rounds that keep the solve off
    the infeasible full-f64 fallback."""
    from ..utils.membudget import budget_bytes
    # 0.25: the f64 operator (+ its emulation temps in the per-row
    # matvecs) needs roughly as much headroom as one extra q/w row pair.
    # Floor at k0+ne: with kalloc == k0 == ne the Rayleigh-Ritz pass has
    # no subspace to rotate (a 1-vector RR is just the Rayleigh
    # quotient) and the refine can NEVER improve the residual.
    budget = int(budget_bytes(0.25) / max(16 * planes * dim, 1))
    return min(96, dim, max(k0 + ne, budget))


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_rows(dst, rows, k):
    """Fixed-shape donated row write at traced offset (one compile per
    allocation stage; an eager ``.at[k:k+ne].set`` bakes the index and
    recompiles per round)."""
    return jax.lax.dynamic_update_slice(dst, rows, (k, 0))


def rayleigh_refine_real_device(matvec_real64, vecs, neigen: int,
                                op64=None, rtol=None, max_expand: int = 16):
    """Device-resident Rayleigh-Ritz refine with residual-block subspace
    expansion: ``vecs`` [k, dim] stays on device throughout; only k x k
    Gram blocks and residual norms touch the host.  Residuals are
    EXPLICIT (``w`` rows hold exact f64 H@q, so the rotated
    ``wx - theta x`` is the true residual — no Gram-identity cancellation
    floor), which lets the acceptance certify vector tolerances down to
    ~eps*||H||.  With ``rtol`` set, expansion writes the orthonormalised
    residual block of the wanted Ritz rows into FIXED preallocated bases
    (zero rows are inert; traced write offset — one compile per stage,
    not per round) until ``resid <= rtol*max(|theta|,1)`` (or
    ``max_expand`` rounds / the HBM cap).
    Returns (theta [ne], new_vecs [ne, dim] DEVICE, resid [ne])."""
    apply_fn, opd, _ = _as_applier(matvec_real64, op64)
    import os as _os
    if _os.environ.get("CDMFT_DEBUG_REFINE"):
        _live = sorted((a.nbytes for a in jax.live_arrays()),
                       reverse=True)
        print(f"# refine entry: live={sum(_live)/1e9:.2f}GB "
              f"top={[round(b_/1e9, 2) for b_ in _live[:10]]}",
              flush=True)
    v0 = jnp.asarray(vecs, jnp.float64)                # [k0, dim]
    k0, dim = v0.shape
    ne = min(neigen, k0)
    k_cap = _refine_k_cap(dim, k0, ne)
    kalloc = k_cap if rtol is not None else k0
    # k x k reductions as CHUNKED grams: both the [k,dim]x[dim,k] matmul
    # and whole-row f64 vdots materialise O(8*dim) f32 temps on this
    # backend (observed 5.3 GB at dim 1.66e8); chunked accumulation keeps
    # the temp at chunk size.  g/hk grow incrementally on the host.
    w0 = jnp.stack([apply_fn(opd, v0[j]) for j in range(k0)])
    jax.block_until_ready(w0)     # surface async OOMs at their source
    g = np.zeros((kalloc, kalloc))
    hk = np.zeros((kalloc, kalloc))
    g[:k0, :k0] = np.asarray(_gram_chunked(v0, v0))
    hk[:k0, :k0] = np.asarray(_gram_chunked(v0, w0))
    # grams first, then the padded planes one at a time with the seed
    # rows freed in between; jnp.pad instead of zeros().at[].set — the
    # eager at-set allocates BOTH the zeros buffer and the copy (2x the
    # plane per set, the OOM margin at the Ns=16 flagship)
    v = jnp.pad(v0, ((0, kalloc - k0), (0, 0)))
    del v0
    w = jnp.pad(w0, ((0, kalloc - k0), (0, 0)))
    del w0
    k_act = k0
    theta = x = resid = None
    rstall = _RefineStall()
    for it in range(max_expand + 1):
        s_t, theta = _canonical_rr(0.5 * (g + g.T)[None],
                                   0.5 * (hk + hk.T)[None])
        s_t, theta = s_t[0], theta[0]
        th = np.where(theta[:ne] >= 1e30, 0.0, theta[:ne])
        s_d = jnp.asarray(np.ascontiguousarray(s_t[:ne].T))   # [k, ne]
        x = _restart_real(v, s_d)                      # [ne, dim] device
        wx = _restart_real(w, s_d)
        r = wx - jnp.asarray(th)[:, None] * x
        del wx                # r holds everything the round still needs
        resid = np.sqrt(np.maximum(
            np.asarray(_gram_chunked(r, r)).diagonal(), 0.0))
        # padded Ritz rows (whitening dropped directions): never accept
        resid = np.where(theta[:ne] >= 1e30, np.inf, resid)
        done = (rtol is None or np.all(
            resid <= rtol * np.maximum(np.abs(th), 1.0)))
        worst = float(np.max(np.where(np.isfinite(resid), resid, 1.0)))
        if done or it == max_expand or k_act + ne > k_cap \
                or rstall.stalled(worst):
            break
        x = None              # rebuilt at the next round's Ritz rotate;
        # holding it through the expansion matvecs was ne extra planes
        # at the Ns=16 flagship
        for _ in range(2):                             # CGS2 vs current v
            c = np.asarray(_gram_chunked(r, v))        # [ne, kalloc]
            r = r - _restart_real(v, jnp.asarray(
                np.ascontiguousarray(c.T)))
        nrm = np.sqrt(np.maximum(
            np.asarray(_gram_chunked(r, r)).diagonal(), 0.0))
        rhat = r / jnp.asarray(np.maximum(nrm, 1e-30))[:, None]
        del r
        # cheap grams BEFORE the expansion matvec: its transients must
        # not stack on top of one more retained plane (OOM margin at
        # the Ns=16 flagship)
        gc = np.asarray(_gram_chunked(rhat, v))        # [ne, kalloc]
        gd = np.asarray(_gram_chunked(rhat, rhat))
        hc = np.asarray(_gram_chunked(rhat, w))
        w_new = jnp.stack([apply_fn(opd, rhat[j]) for j in range(ne)])
        hd = np.asarray(_gram_chunked(rhat, w_new))
        sl = slice(k_act, k_act + ne)
        g[sl, :] = gc
        g[:, sl] = gc.T
        g[sl, sl] = gd
        hk[sl, :] = hc
        hk[:, sl] = hc.T
        hk[sl, sl] = 0.5 * (hd + hd.T)
        v = _write_rows(v, rhat, k_act)
        w = _write_rows(w, w_new, k_act)
        k_act += ne
    return theta[:ne], x, resid


def lanczos_eigh_mixed_real(matvec_real32, matvec_real64, dim: int,
                            neigen: int, ncv: int, maxiter: int = 512,
                            tol: float = 1e-14,
                            v0: Optional[np.ndarray] = None,
                            seed: int = 8527, op32=None,
                            op64=None, device_vectors: bool = False,
                            vec_rtol: Optional[float] = None,
                            op16=None, convert64=None) -> EighResult:
    """Mixed-precision real-plane eigensolver (see
    :func:`lanczos_eigh_mixed`).  ``op32``/``op64`` select the pure
    apply(op, x) form for the two precisions; ``device_vectors`` keeps the
    Krylov output and the refined Ritz vectors device-resident (large
    sectors).

    ``convert64=(to64, from64, dim64)``: the f64 refine may run in a
    DIFFERENT vector layout than the f32 Krylov stage — the two-kit
    scheme runs the f32 stage on the combinadic tile kernels (fastest
    measured f32 H·v) and the refine on the hierarchical kit (whose f64
    operator + emulation temps fit a single chip at Ns=16).  ``to64``/
    ``from64`` map [k, dim] <-> [k, dim64] row batches (one-off
    conversions at the stage boundary, not per matvec).  Requires
    ``device_vectors``."""
    f32_tol = max(tol, 2e-6)
    res32 = lanczos_eigh_real(matvec_real32, dim, neigen=neigen, ncv=ncv,
                              maxiter=maxiter, tol=f32_tol, v0=v0,
                              seed=seed, dtype=jnp.float32, op=op32,
                              device_vectors=device_vectors, op16=op16)
    # free the Krylov-stage operators before the f64 refine: at Ns=16 the
    # f32 diag alone is 668 MB and the refine adds q/w f64 planes + the
    # f64 operator (callers should pass these without keeping their own
    # references — e.g. the box-pop pattern in bench_large).  ``op64``
    # may be a zero-arg callable built LAZILY here, so the f32 and f64
    # operators never coexist in HBM.
    op32 = op16 = None
    if callable(op64):
        op64 = op64()
    rtol = _mixed_vec_rtol(vec_rtol)
    if convert64 is not None:
        assert device_vectors, "convert64 requires device_vectors"
        to64, from64, dim64 = convert64
    else:
        to64 = from64 = (lambda a: a)
        dim64 = dim
    if device_vectors:
        ev32 = res32.eigenvectors
        nmv32 = res32.iterations + ev32.shape[0]
        res32 = None
        ev64 = to64(ev32)
        ev32 = None           # drop the Krylov-layout copy before the
        # refine allocates its q/w planes (1.3 GB each at Ns=16)
        # drain pending work and drop dead buffers before the refine
        # allocates, so the (logically dead) Krylov basis is freed first
        import gc
        jax.block_until_ready(ev64)
        gc.collect()
        theta, vecs, resid = rayleigh_refine_real_device(
            matvec_real64, ev64, neigen, op64=op64, rtol=rtol)
        del ev64
    else:
        mv64 = (matvec_real64 if op64 is None
                else (lambda x: matvec_real64(op64, x)))
        theta, vecs, resid = rayleigh_refine_real(
            mv64, res32.eigenvectors, neigen, rtol=rtol, max_expand=16)
    nmv = (nmv32 if res32 is None
           else res32.iterations + len(res32.eigenvectors))
    ok = np.all(resid <= rtol * np.maximum(np.abs(theta), 1.0))
    if not ok:
        # full-f64 polish at the CALLER's tolerance (not the vector
        # acceptance rtol): cfg.lanc_tolerance keeps its ARPACK tol=0
        # semantics on the fallback path (ADVICE r3).  ncv shrinks to
        # what the f64 basis can afford (1.34 GB/row at Ns=16).
        from ..utils.membudget import budget_bytes
        ncv_fb = min(ncv, max(neigen + 2,
                              int(budget_bytes(0.33) / (dim64 * 8)) - 1))
        v0_64 = np.asarray(vecs[0])
        res64 = lanczos_eigh_real(matvec_real64, dim64, neigen=neigen,
                                  ncv=ncv_fb, maxiter=maxiter,
                                  tol=max(tol, _F64_TOL_FLOOR),
                                  v0=v0_64, seed=seed, op=op64,
                                  device_vectors=device_vectors)
        return EighResult(res64.eigenvalues, from64(res64.eigenvectors),
                          nmv + res64.iterations, res64.converged)
    return EighResult(theta, from64(vecs), nmv, True)





@functools.partial(jax.jit, static_argnames=("nch",))
def _gram_rows_b_jit(a, b_, nch: int):
    d = a.shape[2]
    chunk = d // nch

    def body(i, acc):
        sa = jax.lax.dynamic_slice(
            a, (0, 0, i * chunk), (a.shape[0], a.shape[1], chunk))
        sb = jax.lax.dynamic_slice(
            b_, (0, 0, i * chunk), (b_.shape[0], b_.shape[1], chunk))
        # elementwise + sum (see _gram_chunked_jit: exact f64)
        return acc + jnp.sum(sa[:, :, None, :] * sb[:, None, :, :],
                             axis=-1)

    return jax.lax.fori_loop(
        0, nch, body,
        jnp.zeros((a.shape[0], a.shape[1], b_.shape[1]),
                  jnp.result_type(a, b_)))


def _gram_rows_b(a, b_):
    """[B, k, dim] x [B, l, dim] -> [B, k, l] on device.  f64 inputs
    reduce the minor axis in CHUNKS: an emulated f64 dot
    materialises the full [planes, B, k, l, d] product tensor for a
    minor-axis contraction (reproduced 3.4 GB at B=10, k=l=10, d=1e6 —
    the round-4 DMFT-bench OOM); chunking bounds the temp at ~2^23 f32
    elements per plane.  f32 inputs take the direct einsum."""
    if a.dtype != jnp.float64 and b_.dtype != jnp.float64:
        return jnp.einsum("bkd,bld->bkl", a, b_,
                          precision=jax.lax.Precision.HIGHEST)
    d = a.shape[2]
    kl = a.shape[0] * a.shape[1] * b_.shape[1]
    target = max(1 << 10, (1 << 21) // max(kl, 1))
    nch = 1
    while d // nch > target and d % (nch * 2) == 0:
        nch *= 2
    return _gram_rows_b_jit(a, b_, nch)


@jax.jit
def _rotate_rows_b(s_t, q):
    """rows_out[b, e] = sum_k s_t[b, e, k] * q[b, k]  ([B, E, k]x[B, k, dim])."""
    return jnp.einsum("bek,bkd->bed", s_t, q,
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def _refine_stats_b(q, w):
    """One device call for the refine's small reductions: overlap matrix
    G = <q_k, q_l> and Rayleigh block H = <q_k, H q_l> ([B, k, k] each).
    Residual norms are computed EXPLICITLY from wanted-row rotations
    (:func:`_ritz_resid_rows_b`) — the Gram-identity estimate
    (s^T M s - 2 theta s^T H s + theta^2 s^T G s) cancels near
    sqrt(eps_f64)*|theta| and cannot certify the 1e-10 vector acceptance
    (ADVICE r3)."""
    g = _gram_rows_b(q, q)
    hk = _gram_rows_b(q, w)
    return (0.5 * (g + g.transpose(0, 2, 1)),
            0.5 * (hk + hk.transpose(0, 2, 1)))


@jax.jit
def _ritz_resid_rows_b(q, w, s_t_ne, theta_ne):
    """Rotate the ``ne`` wanted Ritz rows and form their EXPLICIT
    residuals: ``w`` rows hold exact f64 H@q, so wx = H x by linearity.
    Returns (x [B, ne, dim], r [B, ne, dim], resid [B, ne])."""
    x = _rotate_rows_b(s_t_ne, q)
    wx = _rotate_rows_b(s_t_ne, w)
    r = wx - theta_ne[:, :, None] * x
    return x, r, jnp.linalg.norm(r, axis=2)


@functools.lru_cache(maxsize=None)
def _append_rows_real_b(apply_fn):
    """One device call for a refine expansion round (real plane):
    CGS2-orthogonalise the precomputed residual block against ``q``
    (inert zero rows contribute nothing), matvec it, and WRITE it into
    the preallocated bases at traced row offset ``k``.  Fixed shapes —
    one XLA compile per allocation stage instead of one per round (the
    growing-concatenate form recompiled every append) — and
    ``q``/``w`` are DONATED, so the bases update in
    place (ADVICE r3: holding old+new doubled peak HBM)."""
    rows_fn = jax.vmap(apply_fn, in_axes=(None, 1), out_axes=1)

    @functools.partial(jax.jit, donate_argnums=(1, 2))
    def step(op, q, w, r, k):
        for _ in range(2):                         # CGS2 vs current q
            r = r - _rotate_rows_b(_gram_rows_b(r, q), q)
        nrm = jnp.linalg.norm(r, axis=2, keepdims=True)
        rhat = r / jnp.maximum(nrm, 1e-30)
        qn = jax.lax.dynamic_update_slice(q, rhat, (0, k, 0))
        wn = jax.lax.dynamic_update_slice(w, rows_fn(op, rhat), (0, k, 0))
        return qn, wn

    return step


@functools.lru_cache(maxsize=None)
def _rows_applier_real(apply_fn):
    return jax.jit(jax.vmap(apply_fn, in_axes=(None, 1), out_axes=1))


@jax.jit
def _gram_rows_pair_b(ar, ai, br, bi):
    """Complex <a_k|b_l> on split planes -> (re, im) [B, k, l]."""
    re = _gram_rows_b(ar, br) + _gram_rows_b(ai, bi)
    im = _gram_rows_b(ar, bi) - _gram_rows_b(ai, br)
    return re, im


def _rotate_rows_pair(sr, si, vr, vi):
    outr = _rotate_rows_b(sr, vr) - _rotate_rows_b(si, vi)
    outi = _rotate_rows_b(sr, vi) + _rotate_rows_b(si, vr)
    return outr, outi


@jax.jit
def _refine_stats_pair_b(qr, qi, wr, wi):
    gr, gi = _gram_rows_pair_b(qr, qi, qr, qi)
    hr, hi = _gram_rows_pair_b(qr, qi, wr, wi)
    gr = 0.5 * (gr + gr.transpose(0, 2, 1))
    gi = 0.5 * (gi - gi.transpose(0, 2, 1))
    hr = 0.5 * (hr + hr.transpose(0, 2, 1))
    hi = 0.5 * (hi - hi.transpose(0, 2, 1))
    return gr, gi, hr, hi


@jax.jit
def _ritz_resid_rows_pair_b(qr, qi, wr, wi, sr, si, theta):
    """Split-pair twin of :func:`_ritz_resid_rows_b`."""
    xr, xi = _rotate_rows_pair(sr, si, qr, qi)     # [B, ne, dim]
    wxr, wxi = _rotate_rows_pair(sr, si, wr, wi)
    rr_ = wxr - theta[:, :, None] * xr
    ri_ = wxi - theta[:, :, None] * xi
    resid = jnp.sqrt(jnp.sum(rr_ * rr_, axis=2)
                     + jnp.sum(ri_ * ri_, axis=2))
    return xr, xi, rr_, ri_, resid


@functools.lru_cache(maxsize=None)
def _append_rows_pair_b(apply_fn):
    """Split-pair twin of :func:`_append_rows_real_b` (fixed-shape write
    at traced offset, donated bases)."""
    rows_fn = jax.vmap(apply_fn, in_axes=(None, 1, 1), out_axes=1)

    @functools.partial(jax.jit, donate_argnums=(1, 2, 3, 4))
    def step(op, qr, qi, wr, wi, br_, bi_, k):
        for _ in range(2):                         # CGS2 vs current q
            cr, ci = _gram_rows_pair_b(qr, qi, br_, bi_)   # [B, k, ne]
            ct_r = cr.transpose(0, 2, 1)
            ct_i = ci.transpose(0, 2, 1)
            dr, di = _rotate_rows_pair(ct_r, ct_i, qr, qi)
            br_, bi_ = br_ - dr, bi_ - di
        nrm = jnp.sqrt(jnp.sum(br_ * br_, axis=2)
                       + jnp.sum(bi_ * bi_, axis=2))[:, :, None]
        rhr = br_ / jnp.maximum(nrm, 1e-30)
        rhi = bi_ / jnp.maximum(nrm, 1e-30)
        w2r, w2i = rows_fn(op, rhr, rhi)
        upd = jax.lax.dynamic_update_slice
        return (upd(qr, rhr, (0, k, 0)), upd(qi, rhi, (0, k, 0)),
                upd(wr, w2r, (0, k, 0)), upd(wi, w2i, (0, k, 0)))

    return step


@functools.lru_cache(maxsize=None)
def _rows_applier_pair(apply_fn):
    return jax.jit(jax.vmap(apply_fn, in_axes=(None, 1, 1), out_axes=1))


def _canonical_rr(g_np, hk_np):
    """Canonical-orthogonalisation Rayleigh-Ritz per member (host, k<=96):
    whiten with G's eigenbasis (dropping directions with G-eigenvalue
    < 1e-10 of max — duplicate residual rows), then eigh the whitened
    Rayleigh block.  No orthonormality assumption on the basis rows.
    Returns row-major transposed eigvecs s_t [B, k, k] (padded rows zero,
    padded theta +1e30 so they sort after every physical pair)."""
    b, k, _ = g_np.shape
    s_t = np.zeros((b, k, k))
    theta = np.full((b, k), 1e30)
    cplx = np.iscomplexobj(hk_np)
    if cplx:
        s_t = s_t.astype(np.complex128)
    for i in range(b):
        lam, u = np.linalg.eigh(g_np[i])
        keep = lam > 1e-10 * max(lam.max(), 1e-300)
        t = u[:, keep] / np.sqrt(lam[keep])
        hc = t.conj().T @ hk_np[i] @ t
        th, sc = np.linalg.eigh(hc)
        si = t @ sc                                  # [k, k']
        kk = si.shape[1]
        s_t[i, :kk] = si.T
        theta[i, :kk] = th.real
    return s_t, theta


class _RefineStall:
    """Breaks the expansion loop when the worst wanted residual stops
    improving (>=30% per round expected while block-Krylov growth is
    productive): stragglers go to the warm-started f64 fallback instead
    of burning max_expand rounds of matvecs + host RR round trips."""

    def __init__(self, limit: int = 3):
        self.best = np.inf
        self.n = 0
        self.limit = limit

    def stalled(self, cur: float) -> bool:
        if cur < 0.7 * self.best:
            self.best = cur
            self.n = 0
        else:
            self.n += 1
        return self.n >= self.limit


# relative resolution of an f64 matvec: no residual certified through f64
# matvecs is asked to go below it
_F64_TOL_FLOOR = 1e-15


def _mixed_vec_rtol(requested=None) -> float:
    """Acceptance tolerance for the mixed path's refined eigenVECTOR
    residual (relative).  The retained vectors feed the Green's-function
    stage, where a vector error e produces a Sigma error amplified by
    ~1/|G| at the first Matsubara point (observed 4e3 x at beta=1000:
    round-3 shipped 8e-3 Sigma error from 2e-6-residual vectors) — so the
    default is 1e-10, giving f64-physics Sigma (~4e-7).  Eigenvalue error
    is resid^2/gap, far below that.  ``requested`` (the
    ``ed_mixed_vec_tol`` config field) overrides the default; the
    CDMFT_MIXED_RTOL env var overrides both (debug lever).  Members that
    miss this after the expansion refine are re-solved in full f64 at the
    caller's lanc_tolerance."""
    import os
    env = os.environ.get("CDMFT_MIXED_RTOL")
    if env:
        return float(env)
    base = float(requested) if requested else 1e-10
    # never certify below what the backend's f64 matvec can resolve
    return max(base, _F64_TOL_FLOOR)



def rayleigh_refine_real_batched(matvec_batched64, vecs: np.ndarray,
                                 neigen: int, op64=None, rtol=None,
                                 max_expand: int = 24, batch_mesh=None):
    """Batched real Rayleigh-Ritz refine, DEVICE-resident: vecs
    [B, k, dim] approximate (f32) eigenbases refined by residual-block
    subspace expansion until every member's wanted residuals meet
    ``rtol*max(|theta|,1)`` (or ``max_expand`` rounds / the HBM cap).
    Two device calls per round (small-reduction stats + fused
    rotate/residual/CGS2/append/matvec step); only k x k blocks and
    residual norms touch the host — the previous host-numpy loop spent
    seconds per round in einsums at production bucket sizes.
    Returns (theta [B, ne], vecs [B, ne, dim], resid [B, ne])."""
    apply_fn, opd, cached = _as_applier(matvec_batched64, op64)
    step = (_append_rows_real_b(apply_fn) if cached
            else _append_rows_real_b.__wrapped__(apply_fn))
    rows_fn = (_rows_applier_real(apply_fn) if cached
               else jax.vmap(apply_fn, in_axes=(None, 1), out_axes=1))
    b, k0, dim = vecs.shape
    ne = neigen
    bput = _batch_put(batch_mesh)
    # HBM cap: q + w are [B, k, dim] f64 each.  Bases are preallocated
    # at STAGED sizes (first k0+4*ne, then k_cap) with zero rows — zero
    # rows are inert through the Gram/whitening — and appends write at a
    # TRACED offset: two compiled shape families per bucket instead of
    # one compile per round (the growing shapes recompiled every append).
    from ..utils.membudget import budget_bytes
    k_cap = max(k0, min(96, dim,
                        int(budget_bytes(0.125) / max(16 * b * dim, 1))))
    stages = [k0] if rtol is None else \
        sorted({min(k0 + 4 * ne, k_cap), k_cap})
    kalloc = stages[0]
    v64 = jnp.asarray(np.ascontiguousarray(np.real(vecs)), jnp.float64)
    q = bput(jnp.zeros((b, kalloc, dim), jnp.float64).at[:, :k0].set(v64))
    w0 = rows_fn(opd, bput(v64))
    w = bput(jnp.zeros((b, kalloc, dim), jnp.float64).at[:, :k0].set(w0))
    del v64, w0
    k_act = k0
    theta = resid_np = x = None
    rstall = _RefineStall()
    for it in range(max_expand + 1):
        _dispatch.tick("refine.round", 2)
        g_np, hk_np = map(np.asarray, _refine_stats_b(q, w))
        s_t, theta = _canonical_rr(g_np, hk_np)
        th = np.where(theta[:, :ne] >= 1e30, 0.0, theta[:, :ne])
        x, r, resid_d = _ritz_resid_rows_b(
            q, w, jnp.asarray(np.ascontiguousarray(s_t[:, :ne])),
            jnp.asarray(th))
        resid_np = np.asarray(resid_d)
        # padded Ritz rows (whitening dropped directions, kk < ne):
        # never accept — forces the f64 fallback for that member
        resid_np = np.where(theta[:, :ne] >= 1e30, np.inf, resid_np)
        done = (rtol is None or np.all(
            resid_np <= rtol * np.maximum(np.abs(th), 1.0)))
        worst = float(np.max(np.where(np.isfinite(resid_np), resid_np,
                                      1.0)))
        if done or it == max_expand or k_act + ne > k_cap \
                or rstall.stalled(worst):
            break
        if k_act + ne > kalloc:            # grow to the next stage
            kalloc = min(s for s in stages if s >= k_act + ne)
            pad = kalloc - q.shape[1]
            q = bput(jnp.pad(q, ((0, 0), (0, pad), (0, 0))))
            w = bput(jnp.pad(w, ((0, 0), (0, pad), (0, 0))))
        q, w = step(opd, q, w, r, k_act)
        k_act += ne
    xv = np.asarray(x)
    nrm = np.linalg.norm(xv, axis=2, keepdims=True)
    return (theta[:, :ne], xv / np.maximum(nrm, 1e-300), resid_np)


def lanczos_eigh_mixed_real_batched(matvec_batched32, matvec_batched64,
                                    nbatch: int, dim: int, neigen: int,
                                    ncv: int, maxiter: int = 512,
                                    tol: float = 1e-14,
                                    v0: Optional[np.ndarray] = None,
                                    seed: int = 8527, op32=None,
                                    op64=None, fallback64=None,
                                    vec_rtol: Optional[float] = None,
                                    batch_mesh=None):
    """Mixed-precision sector-parallel dispatch: B same-bucket REAL
    sectors run ONE batched f32 thick-restart Lanczos stream, refined by
    a batched f64 Rayleigh-Ritz expansion
    pass certifying the retained eigenvectors at ``vec_rtol`` (explicit
    residuals; see :func:`_mixed_vec_rtol`).  Members whose refined
    residual misses the target are re-solved via
    ``fallback64(i, v0_row) -> EighResult`` (an individual f64
    thick-restart solve at the caller's tolerance).

    Returns a list of ``nbatch`` :class:`EighResult` — combining the
    reference-missing sector parallelism (ED_DIAG.f90:78 is serial) with
    the f32-Krylov throughput scheme."""
    f32_tol = max(tol, 2e-6)
    res32 = lanczos_eigh_real_batched(
        matvec_batched32, nbatch, dim, neigen=neigen, ncv=ncv,
        maxiter=maxiter, tol=f32_tol, v0=v0, seed=seed, op=op32,
        dtype=jnp.float32, batch_mesh=batch_mesh)
    # free the f32 operator stack BEFORE materialising the f64 one: the
    # refine never touches op32, and holding both costs ~1.5x the f64-only
    # operator HBM footprint (ADVICE round 1).  ``op64`` may be a zero-arg
    # thunk resolved only now, after the Krylov stage.
    del op32
    if callable(op64):
        op64 = op64()
    vecs32 = np.stack([r.eigenvectors for r in res32])   # [B, ne, dim]
    rtol = _mixed_vec_rtol(vec_rtol)
    theta, vecs, resid = rayleigh_refine_real_batched(
        matvec_batched64, vecs32, neigen, op64=op64, rtol=rtol,
        batch_mesh=batch_mesh)
    okm = np.all(resid <= rtol * np.maximum(np.abs(theta), 1.0), axis=1)
    out = []
    for i in range(nbatch):
        nmv = res32[i].iterations + vecs32.shape[1]
        if okm[i] or fallback64 is None:
            out.append(EighResult(theta[i].copy(), vecs[i].copy(), nmv,
                                  bool(okm[i])))
        else:
            r64 = fallback64(i, vecs[i, 0])
            out.append(EighResult(r64.eigenvalues, r64.eigenvectors,
                                  nmv + r64.iterations, r64.converged))
    return out


def rayleigh_refine_split_batched(matvec_pair_batched64, vecs: np.ndarray,
                                  neigen: int, op64=None, rtol=None,
                                  max_expand: int = 24, batch_mesh=None):
    """Batched complex Rayleigh-Ritz refine on the split-pair kernel:
    vecs [B, k, dim] complex approximate eigenbases, one batched f64 pair
    matvec (xr, xi) [B, dim] -> (wr, wi).  ``rtol``/``max_expand`` as in
    :func:`rayleigh_refine_real_batched`.
    Returns (theta [B, ne], vecs [B, ne, dim] complex, resid [B, ne])."""
    apply_fn, opd, cached = _as_applier(matvec_pair_batched64, op64)
    step = (_append_rows_pair_b(apply_fn) if cached
            else _append_rows_pair_b.__wrapped__(apply_fn))
    rows_fn = (_rows_applier_pair(apply_fn) if cached
               else jax.vmap(apply_fn, in_axes=(None, 1, 1), out_axes=1))
    b, k0, dim = vecs.shape
    ne = neigen
    from ..utils.membudget import budget_bytes
    k_cap = max(k0, min(96, dim,
                        int(budget_bytes(0.125) / max(32 * b * dim, 1))))
    bput = _batch_put(batch_mesh)
    # staged fixed-shape bases: see rayleigh_refine_real_batched
    stages = [k0] if rtol is None else \
        sorted({min(k0 + 4 * ne, k_cap), k_cap})
    kalloc = stages[0]

    def alloc(host, w_rows=None):
        z = jnp.zeros((b, kalloc, dim), jnp.float64)
        return bput(z.at[:, :k0].set(host if w_rows is None else w_rows))

    vr64 = jnp.asarray(np.ascontiguousarray(vecs.real), jnp.float64)
    vi64 = jnp.asarray(np.ascontiguousarray(vecs.imag), jnp.float64)
    qr, qi = alloc(vr64), alloc(vi64)
    w0r, w0i = rows_fn(opd, bput(vr64), bput(vi64))
    wr, wi = alloc(None, w0r), alloc(None, w0i)
    del vr64, vi64, w0r, w0i
    k_act = k0
    theta = resid_np = xr = xi = None
    rstall = _RefineStall()
    for it in range(max_expand + 1):
        gr, gi, hr, hi = map(
            np.asarray, _refine_stats_pair_b(qr, qi, wr, wi))
        s_t, theta = _canonical_rr(gr + 1j * gi, hr + 1j * hi)
        th = np.where(theta[:, :ne] >= 1e30, 0.0, theta[:, :ne])
        xr, xi, rr_, ri_, resid_d = _ritz_resid_rows_pair_b(
            qr, qi, wr, wi,
            jnp.asarray(np.ascontiguousarray(s_t[:, :ne].real)),
            jnp.asarray(np.ascontiguousarray(s_t[:, :ne].imag)),
            jnp.asarray(th))
        resid_np = np.asarray(resid_d)
        resid_np = np.where(theta[:, :ne] >= 1e30, np.inf, resid_np)
        done = (rtol is None or np.all(
            resid_np <= rtol * np.maximum(np.abs(th), 1.0)))
        worst = float(np.max(np.where(np.isfinite(resid_np), resid_np,
                                      1.0)))
        if done or it == max_expand or k_act + ne > k_cap \
                or rstall.stalled(worst):
            break
        if k_act + ne > kalloc:            # grow to the next stage
            kalloc = min(s for s in stages if s >= k_act + ne)
            pad = kalloc - qr.shape[1]
            pads = ((0, 0), (0, pad), (0, 0))
            qr, qi = bput(jnp.pad(qr, pads)), bput(jnp.pad(qi, pads))
            wr, wi = bput(jnp.pad(wr, pads)), bput(jnp.pad(wi, pads))
        qr, qi, wr, wi = step(opd, qr, qi, wr, wi, rr_, ri_, k_act)
        k_act += ne
    xv = np.asarray(xr) + 1j * np.asarray(xi)
    nrm = np.linalg.norm(xv, axis=2, keepdims=True)
    return (theta[:, :ne], xv / np.maximum(nrm, 1e-300), resid_np)


def lanczos_eigh_mixed_split_batched(matvec_batched32, matvec_batched64,
                                     nbatch: int, dim: int, neigen: int,
                                     ncv: int, maxiter: int = 512,
                                     tol: float = 1e-14,
                                     v0: Optional[np.ndarray] = None,
                                     seed: int = 8527, op32=None,
                                     op64=None, fallback64=None,
                                     vec_rtol: Optional[float] = None,
                                     batch_mesh=None):
    """Complex-sector twin of :func:`lanczos_eigh_mixed_real_batched`:
    batched f32 split-pair thick-restart Lanczos + batched f64
    Rayleigh-Ritz expansion refine (explicit-residual vector
    acceptance), with a per-member f64 fallback at the caller's tol."""
    f32_tol = max(tol, 2e-6)
    res32 = lanczos_eigh_split_batched(
        matvec_batched32, nbatch, dim, neigen=neigen, ncv=ncv,
        maxiter=maxiter, tol=f32_tol, v0=v0, seed=seed, op=op32,
        dtype=jnp.float32, batch_mesh=batch_mesh)
    del op32                        # see lanczos_eigh_mixed_real_batched
    if callable(op64):
        op64 = op64()
    vecs32 = np.stack([r.eigenvectors for r in res32])   # [B, ne, dim]
    rtol = _mixed_vec_rtol(vec_rtol)
    theta, vecs, resid = rayleigh_refine_split_batched(
        matvec_batched64, vecs32, neigen, op64=op64, rtol=rtol,
        batch_mesh=batch_mesh)
    okm = np.all(resid <= rtol * np.maximum(np.abs(theta), 1.0), axis=1)
    out = []
    for i in range(nbatch):
        nmv = res32[i].iterations + vecs32.shape[1]
        if okm[i] or fallback64 is None:
            out.append(EighResult(theta[i].copy(), vecs[i].copy(), nmv,
                                  bool(okm[i])))
        else:
            r64 = fallback64(i, vecs[i, 0])
            out.append(EighResult(r64.eigenvalues, r64.eigenvectors,
                                  nmv + r64.iterations, r64.converged))
    return out


@functools.lru_cache(maxsize=None)
def _expand_block_split(apply_fn):
    """Whole-restart CGS2 Lanczos expansion in ONE device call (accelerator path).

    Scans j = 0..ncv-1 with masked updates (steps j < k are skipped when
    resuming from a thick restart of size k), so every restart costs a
    single host-device round trip instead of ncv.  The Krylov basis lives
    as two separate
    f64 planes (br, bi) [ncv+1, dim]; ``apply_fn(op, vr, vi)`` pure.
    Returns the projection columns [ncv, ncv] (re/im) and betas [ncv]."""
    P = jax.lax.Precision.HIGHEST

    @functools.partial(jax.jit, donate_argnums=(1, 2))
    def expand(op, br, bi, k):
        ncv1 = br.shape[0]

        def do_step(args):
            br, bi, j = args
            wr, wi = apply_fn(op, br[j], bi[j])
            mask = (jnp.arange(ncv1) <= j)

            def proj(wr, wi):
                cr = jnp.where(mask, jnp.matmul(br, wr, precision=P)
                               + jnp.matmul(bi, wi, precision=P), 0.0)
                ci = jnp.where(mask, jnp.matmul(br, wi, precision=P)
                               - jnp.matmul(bi, wr, precision=P), 0.0)
                return cr, ci

            c1r, c1i = proj(wr, wi)
            wr = wr - (jnp.matmul(c1r, br, precision=P)
                       - jnp.matmul(c1i, bi, precision=P))
            wi = wi - (jnp.matmul(c1r, bi, precision=P)
                       + jnp.matmul(c1i, br, precision=P))
            c2r, c2i = proj(wr, wi)
            wr = wr - (jnp.matmul(c2r, br, precision=P)
                       - jnp.matmul(c2i, bi, precision=P))
            wi = wi - (jnp.matmul(c2r, bi, precision=P)
                       + jnp.matmul(c2i, br, precision=P))
            beta = jnp.sqrt(jnp.sum(wr ** 2 + wi ** 2))
            denom = jnp.maximum(beta, 1e-30)
            br = br.at[j + 1].set(wr / denom)
            bi = bi.at[j + 1].set(wi / denom)
            return br, bi, (c1r + c2r)[: ncv1 - 1], \
                (c1i + c2i)[: ncv1 - 1], beta

        def skip_step(args):
            br, bi, j = args
            z = jnp.zeros(ncv1 - 1, br.dtype)
            return br, bi, z, z, jnp.asarray(0.0, br.dtype)

        def step(carry, j):
            br, bi = carry
            br, bi, cr, ci, beta = jax.lax.cond(
                j >= k, do_step, skip_step, (br, bi, j))
            return (br, bi), (cr, ci, beta)

        (br, bi), (crs, cis, betas) = jax.lax.scan(
            step, (br, bi), jnp.arange(ncv1 - 1))
        return br, bi, crs, cis, betas

    return expand


@functools.lru_cache(maxsize=None)
def _fused_restart_expand_split(apply_fn):
    """Split-pair twin of :func:`_fused_restart_expand_real`: restart +
    CGS2 expansion in one device call; packed [2*ncv+1, ncv] transfer
    (re columns, im columns, betas)."""
    P = jax.lax.Precision.HIGHEST
    inner = _expand_block_split.__wrapped__(apply_fn)

    @functools.partial(jax.jit, donate_argnums=(1, 2))
    def step(op, br, bi, sr_k, si_k, k):
        ncv1 = br.shape[0]
        ncv = ncv1 - 1
        kk = sr_k.shape[1]    # STATIC restart size (in-place rotation)

        # unconditional in-place rotation (identity on round 1; see
        # the real-plane factory)
        def body(r, accs):
            nr, ni = accs
            nr = nr + sr_k[r][:, None] * br[r][None, :] \
                - si_k[r][:, None] * bi[r][None, :]
            ni = ni + sr_k[r][:, None] * bi[r][None, :] \
                + si_k[r][:, None] * br[r][None, :]
            return nr, ni

        z = jnp.zeros((kk, br.shape[1]), br.dtype)
        nr, ni = jax.lax.fori_loop(0, ncv, body, (z, z))
        lr, li = br[ncv], bi[ncv]
        br = jax.lax.dynamic_update_slice(br, nr, (0, 0))
        br = br.at[kk].set(jnp.where(k > 0, lr, br[kk]))
        bi = jax.lax.dynamic_update_slice(bi, ni, (0, 0))
        bi = bi.at[kk].set(jnp.where(k > 0, li, bi[kk]))
        br, bi, crs, cis, betas = inner(op, br, bi, k)
        return br, bi, jnp.concatenate([crs, cis, betas[None, :]],
                                       axis=0)

    return step


def lanczos_eigh_split(matvec_pair, dim: int, neigen: int, ncv: int,
                       maxiter: int = 512, tol: float = 1e-14,
                       v0: Optional[np.ndarray] = None,
                       seed: int = 8527, dtype=jnp.float64,
                       op=None, device_vectors: bool = False,
                       op16=None) -> EighResult:
    """Thick-restart Lanczos on the split-pair representation (accelerator path).
    Same semantics as :func:`lanczos_eigh`; eigenvectors are returned as a
    host complex array [neigen, dim].

    ``dtype=jnp.float32`` keeps the whole device iteration (basis planes,
    matvec, CGS2) in f32 for the mixed-precision scheme — an f64 basis
    would silently promote the f32 matvec results back to f64."""
    neigen = min(neigen, dim)
    ncv = int(min(max(ncv, neigen + 2), dim))
    eps = float(np.finfo(np.dtype(dtype).name).eps)
    tol = max(tol, eps)

    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.normal(size=(2, dim))
    else:
        v0 = np.stack([np.real(v0), np.imag(v0)])
    v0 = v0 / np.linalg.norm(v0)

    br = _basis_init(ncv + 1, dim, dtype)(jnp.asarray(v0[0], dtype))
    bi = _basis_init(ncv + 1, dim, dtype)(jnp.asarray(v0[1], dtype))
    t_proj = np.zeros((ncv, ncv), dtype=np.complex128)
    apply_fn, opd, cached = _as_applier(matvec_pair, op)
    # see lanczos_eigh_real: fused single-call rounds below the HBM
    # threshold, classic aliasing-safe split calls above it
    fused_mode = 2 * (ncv + 1) * dim * np.dtype(
        np.dtype(dtype).name).itemsize <= (1 << 30)
    if fused_mode:
        fused = (_fused_restart_expand_split(apply_fn) if cached
                 else _fused_restart_expand_split.__wrapped__(apply_fn))
    else:
        expand = (_expand_block_split(apply_fn) if cached
                  else _expand_block_split.__wrapped__(apply_fn))

    restart_basis = _restart_split

    k = 0
    nmv = 0
    stall = _StallGuard()
    coarse = op16 is not None
    kfix = min(neigen + max(neigen, (ncv - neigen) // 2), ncv - 1)
    sr_dev = jnp.asarray(np.eye(ncv, kfix), dtype) if fused_mode else None
    si_dev = jnp.zeros((ncv, kfix), dtype) if fused_mode else None
    s_host = None
    while True:
        if fused_mode:
            # ONE device call per restart round (rotate-restart + CGS2
            # expansion) and one packed transfer (utils/dispatch.py
            # counts)
            br, bi, packed = fused(op16 if coarse else opd, br, bi,
                                   sr_dev, si_dev, k)
            _dispatch.tick("lanczos.fused_round")
            arr = np.asarray(packed)
            crs = arr[:ncv]
            cis = arr[ncv:2 * ncv]
            betas_np = arr[2 * ncv]
        else:
            if k > 0:
                sj = s_host[:, :k]
                sr = jnp.asarray(np.ascontiguousarray(sj.real), dtype)
                si = jnp.asarray(np.ascontiguousarray(sj.imag), dtype)
                nr, ni = restart_basis(br, bi, sr, si)
                last_r, last_i = br[ncv], bi[ncv]
                br = bi = None
                _dispatch.tick("lanczos.restart", 3)
                br = _basis_restart_pack(ncv + 1, k, dtype)(nr, last_r)
                bi = _basis_restart_pack(ncv + 1, k, dtype)(ni, last_i)
                del nr, ni, last_r, last_i
            br, bi, crs_d, cis_d, betas_d = expand(
                op16 if coarse else opd, br, bi, k)
            _dispatch.tick("lanczos.expand")
            crs = np.asarray(crs_d)
            cis = np.asarray(cis_d)
            betas_np = np.asarray(betas_d)
        for j in range(k, ncv):
            col = crs[j] + 1j * cis[j]
            t_proj[: j + 1, j] = col[: j + 1]
            t_proj[j, : j + 1] = col[: j + 1].conj()
            beta_f = float(betas_np[j])
            if j + 1 < ncv:
                t_proj[j + 1, j] = beta_f
                t_proj[j, j + 1] = beta_f
            nmv += 1
        last_beta = beta_f

        theta, s = np.linalg.eigh(t_proj)
        resid = np.abs(last_beta * s[-1, :])
        rel = resid[:neigen] / np.maximum(np.abs(theta[:neigen]), 1.0)
        conv = rel <= tol
        if coarse and (float(rel.max()) < 3e-3
                       or stall.stalled(float(rel.max()))
                       or nmv >= maxiter // 2):
            coarse = False                    # bf16 stage done (see
            op16 = None                       # lanczos_eigh_real)
            stall = _StallGuard()
        if coarse:
            # never accept bf16-grade Ritz data (ADVICE r4)
            conv = np.zeros_like(conv)
        if bool(conv.all()) or nmv >= maxiter or ncv >= dim \
                or (not coarse and stall.stalled(float(rel.max()))):
            sr = jnp.asarray(np.ascontiguousarray(s[:, :neigen].real))
            si = jnp.asarray(np.ascontiguousarray(s[:, :neigen].imag))
            nr, ni = restart_basis(br, bi, sr, si)
            if device_vectors:
                # large sectors: the Ritz pair planes stay DEVICE-resident
                # (no O(neigen*dim) complex host round-trip; mirrors the
                # real path, ED_EIGENSPACE.f90:499-569)
                nr = nr.astype(jnp.float64)
                ni = ni.astype(jnp.float64)
                nrm = np.array([float(np.sqrt(
                    _dot_chunked(nr[j], nr[j])
                    + _dot_chunked(ni[j], ni[j])))
                    for j in range(neigen)])
                sc = jnp.asarray(1.0 / np.maximum(nrm, 1e-300))[:, None]
                return EighResult(theta[:neigen].copy(),
                                  (nr * sc, ni * sc), nmv,
                                  _conv_ok(conv, rel, eps, dim))
            vecs = np.asarray(nr) + 1j * np.asarray(ni)
            nrm = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = vecs / np.maximum(nrm, 1e-300)
            return EighResult(theta[:neigen].copy(), vecs, nmv,
                              _conv_ok(conv, rel, eps, dim))

        k = kfix
        # restart runs on device inside the next fused round
        if fused_mode:
            sk = s[:, :kfix]
            sr_dev = jnp.asarray(np.ascontiguousarray(sk.real), dtype)
            si_dev = jnp.asarray(np.ascontiguousarray(sk.imag), dtype)
        else:
            s_host = s
        t_proj[:] = 0.0
        t_proj[:k, :k] = np.diag(theta[:k])
        b_row = last_beta * s[-1, :k].conj()
        t_proj[k, :k] = b_row
        t_proj[:k, k] = b_row.conj()


# ---------------------------------------------------------------------------
# thick-restart Lanczos with full reorthogonalisation
# ---------------------------------------------------------------------------

class EighResult(NamedTuple):
    eigenvalues: np.ndarray       # [neigen] ascending
    eigenvectors: jax.Array       # [neigen, dim] (rows are vectors)
    iterations: int
    converged: bool


def _expand_step(matvec):
    """One masked CGS2 Lanczos expansion step, jitted once per shape."""

    @jax.jit
    def step(basis, j):
        # basis: [ncv+1, dim]; expand from vector j -> produce v_{j+1}
        ncv1, _ = basis.shape
        v = basis[j]
        w = matvec(v)
        mask = (jnp.arange(ncv1) <= j)
        # first CGS pass: projected column t = V^H w (masked)
        c1 = jnp.where(mask, basis.conj() @ w, 0.0)
        w = w - c1 @ basis
        # second pass for orthogonality at machine precision
        c2 = jnp.where(mask, basis.conj() @ w, 0.0)
        w = w - c2 @ basis
        beta = jnp.linalg.norm(w)
        w = w / jnp.maximum(beta, 1e-300)
        basis = basis.at[j + 1].set(w)
        return basis, c1 + c2, beta

    return step


def lanczos_eigh(matvec: Callable, dim: int, neigen: int,
                 ncv: int, maxiter: int = 512, tol: float = 1e-14,
                 v0: Optional[jax.Array] = None,
                 dtype=jnp.complex128, seed: int = 8527) -> EighResult:
    """Lowest ``neigen`` eigenpairs of the Hermitian operator ``matvec``.

    ARPACK-equivalent semantics (implicit restart replaced by thick restart):
    ``ncv`` is the Krylov block size, ``maxiter`` caps total matvecs
    (lanc_niter), ``tol`` the relative Ritz-residual tolerance
    (lanc_tolerance; clamped to machine precision like ARPACK's tol<=0).
    """
    neigen = min(neigen, dim)
    ncv = int(min(max(ncv, neigen + 2), dim))
    eps = float(np.finfo(np.float64).eps)
    tol = max(tol, eps)

    if v0 is None:
        key = jax.random.PRNGKey(seed)
        v0 = (jax.random.normal(key, (dim,), jnp.float64)
              + 1j * jax.random.normal(jax.random.fold_in(key, 1),
                                       (dim,), jnp.float64)).astype(dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    basis = jnp.zeros((ncv + 1, dim), dtype).at[0].set(v0)
    t_proj = np.zeros((ncv, ncv), dtype=np.complex128)
    step = _expand_step(matvec)

    k = 0                 # locked/restart prefix size
    nmv = 0
    ritz_vals = np.zeros(0)
    stall = _StallGuard()
    while True:
        # expand k -> ncv
        for j in range(k, ncv):
            basis, col, beta = step(basis, j)
            col_np = np.asarray(col)[:ncv]
            t_proj[: j + 1, j] = col_np[: j + 1]
            t_proj[j, : j + 1] = col_np[: j + 1].conj()
            beta_f = float(beta)
            if j + 1 < ncv:
                t_proj[j + 1, j] = beta_f
                t_proj[j, j + 1] = beta_f
            nmv += 1
        last_beta = beta_f

        theta, s = np.linalg.eigh(t_proj)
        resid = np.abs(last_beta * s[-1, :])
        rel = resid[:neigen] / np.maximum(np.abs(theta[:neigen]), 1.0)
        conv = rel <= tol
        ritz_vals = theta[:neigen]
        if bool(conv.all()) or nmv >= maxiter or ncv >= dim \
                or stall.stalled(float(rel.max())):
            svec = jnp.asarray(s[:, :neigen])
            vecs = (svec.T @ basis[:ncv]).astype(dtype)
            # renormalise (guards tiny CGS drift)
            nrm = jnp.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = vecs / jnp.maximum(nrm, 1e-300)
            return EighResult(ritz_vals.copy(), vecs, nmv, _conv_ok(conv, rel, eps, dim))

        # thick restart: keep k Ritz vectors + the residual direction
        k = min(neigen + max(neigen, (ncv - neigen) // 2), ncv - 1)
        svec = jnp.asarray(s[:, :k])
        new_basis = jnp.zeros_like(basis)
        new_basis = new_basis.at[:k].set((svec.T @ basis[:ncv]).astype(dtype))
        new_basis = new_basis.at[k].set(basis[ncv])
        basis = new_basis
        t_proj[:] = 0.0
        t_proj[:k, :k] = np.diag(theta[:k])
        b_row = last_beta * s[-1, :k].conj()
        t_proj[k, :k] = b_row
        t_proj[:k, k] = b_row.conj()


def rayleigh_refine(matvec_pair64, vecs: np.ndarray, neigen: int,
                    rtol=None, max_expand: int = 2):
    """f64 Rayleigh-Ritz refinement of an approximate eigenbasis.

    vecs : complex [k, dim] approximate eigenvectors (e.g. from an f32
    Krylov run).  Orthonormalises in f64, applies H once per vector with
    the f64 kernel, diagonalises the k x k Rayleigh quotient.  Energy
    error ~ ||residual||^2 / gap: 1e-6-accurate f32 vectors give
    ~1e-12-accurate energies (the standard mixed-precision scheme used by
    the accelerator ground-state literature, e.g. arXiv:2111.10466).  With
    ``rtol`` set, residual-block expansion runs as in
    :func:`rayleigh_refine_real`."""
    k, dim = vecs.shape
    q, _ = np.linalg.qr(vecs.T)            # [dim, k] orthonormal

    def hcols(cols):
        out = np.empty_like(cols)
        for j in range(cols.shape[1]):
            cj = np.ascontiguousarray(cols[:, j])
            wr, wi = matvec_pair64(jnp.asarray(cj.real),
                                   jnp.asarray(cj.imag))
            out[:, j] = np.asarray(wr) + 1j * np.asarray(wi)
        return out

    theta, new_vecs, resid = _refine_loop_host(
        hcols, q, neigen, rtol, max_expand, dim, complex_=True)
    return theta[:neigen], new_vecs.T[:neigen], resid[:neigen]


def _rotate_pair_rows(vr, vi, c):
    """rows_out = c @ (vr + i vi) for host complex c [e, k] and device
    split planes [k, dim] -> device (re, im) [e, dim]."""
    sr = jnp.asarray(np.ascontiguousarray(c.real.T))
    si = jnp.asarray(np.ascontiguousarray(c.imag.T))
    return _restart_split(vr, vi, sr, si)


def rayleigh_refine_split_device(matvec_pair64, vecs, neigen: int,
                                 op64=None, rtol=None, max_expand: int = 16):
    """Device-resident split-pair Rayleigh-Ritz refine with residual-block
    expansion: ``vecs`` is a (re, im) plane pair [k, dim]; the planes
    never leave the device; only k x k Gram blocks and residual norms
    touch the host.  Residuals are EXPLICIT (see
    :func:`rayleigh_refine_real_device`).  Returns
    (theta [ne], (nr, ni) [ne, dim] DEVICE pair, resid [ne])."""
    apply_fn, opd, _ = _as_applier(matvec_pair64, op64)
    vr0 = jnp.asarray(vecs[0], jnp.float64)
    vi0 = jnp.asarray(vecs[1], jnp.float64)
    k0, dim = vr0.shape
    ne = min(neigen, k0)
    k_cap = _refine_k_cap(dim, k0, ne, planes=2)
    kalloc = k_cap if rtol is not None else k0

    def apply_rows(ar, ai, n):
        ws = [apply_fn(opd, ar[j], ai[j]) for j in range(n)]
        return (jnp.stack([w[0] for w in ws]),
                jnp.stack([w[1] for w in ws]))

    wr0, wi0 = apply_rows(vr0, vi0, k0)
    vr = jnp.zeros((kalloc, dim), jnp.float64).at[:k0].set(vr0)
    vi = jnp.zeros((kalloc, dim), jnp.float64).at[:k0].set(vi0)
    wr = jnp.zeros((kalloc, dim), jnp.float64).at[:k0].set(wr0)
    wi = jnp.zeros((kalloc, dim), jnp.float64).at[:k0].set(wi0)
    g = np.zeros((kalloc, kalloc), np.complex128)
    hk = np.zeros((kalloc, kalloc), np.complex128)
    g[:k0, :k0] = _gram_pair_chunked(vr0, vi0, vr0, vi0)
    hk[:k0, :k0] = _gram_pair_chunked(vr0, vi0, wr0, wi0)
    del vr0, vi0, wr0, wi0
    k_act = k0
    theta = xr = xi = resid = None
    rstall = _RefineStall()
    for it in range(max_expand + 1):
        s_t, theta = _canonical_rr(0.5 * (g + g.conj().T)[None],
                                   0.5 * (hk + hk.conj().T)[None])
        s_t, theta = s_t[0], theta[0]
        th = np.where(theta[:ne] >= 1e30, 0.0, theta[:ne])
        xr, xi = _rotate_pair_rows(vr, vi, s_t[:ne])   # [ne, dim]
        wxr, wxi = _rotate_pair_rows(wr, wi, s_t[:ne])
        thd = jnp.asarray(th)[:, None]
        rr_ = wxr - thd * xr
        ri_ = wxi - thd * xi
        resid = np.sqrt(np.maximum(
            np.asarray(_gram_chunked(rr_, rr_)).diagonal()
            + np.asarray(_gram_chunked(ri_, ri_)).diagonal(), 0.0))
        resid = np.where(theta[:ne] >= 1e30, np.inf, resid)
        done = (rtol is None or np.all(
            resid <= rtol * np.maximum(np.abs(th), 1.0)))
        worst = float(np.max(np.where(np.isfinite(resid), resid, 1.0)))
        if done or it == max_expand or k_act + ne > k_cap \
                or rstall.stalled(worst):
            break
        for _ in range(2):                             # CGS2 vs current v
            # c[e, k] = <v_k | r_e>; r_e -= sum_k c[e, k] v_k
            c = _gram_pair_chunked(vr, vi, rr_, ri_).T  # [ne, kalloc]
            dr, di = _rotate_pair_rows(vr, vi, c)
            rr_, ri_ = rr_ - dr, ri_ - di
        nrm = np.sqrt(np.maximum(
            np.asarray(_gram_chunked(rr_, rr_)).diagonal()
            + np.asarray(_gram_chunked(ri_, ri_)).diagonal(), 0.0))
        scl = jnp.asarray(1.0 / np.maximum(nrm, 1e-30))[:, None]
        rhr, rhi = rr_ * scl, ri_ * scl
        w2r, w2i = apply_rows(rhr, rhi, ne)
        gc = _gram_pair_chunked(rhr, rhi, vr, vi)      # [ne, kalloc]
        gd = _gram_pair_chunked(rhr, rhi, rhr, rhi)
        hc = _gram_pair_chunked(rhr, rhi, wr, wi)
        hd = _gram_pair_chunked(rhr, rhi, w2r, w2i)
        sl = slice(k_act, k_act + ne)
        g[sl, :] = gc
        g[:, sl] = gc.conj().T
        g[sl, sl] = gd
        hk[sl, :] = hc
        hk[:, sl] = hc.conj().T
        hk[sl, sl] = 0.5 * (hd + hd.conj().T)
        vr = _write_rows(vr, rhr, k_act)
        vi = _write_rows(vi, rhi, k_act)
        wr = _write_rows(wr, w2r, k_act)
        wi = _write_rows(wi, w2i, k_act)
        k_act += ne
    return theta[:ne], (xr, xi), resid


def lanczos_eigh_mixed(matvec_pair32, matvec_pair64, dim: int, neigen: int,
                       ncv: int, maxiter: int = 512, tol: float = 1e-14,
                       v0: Optional[np.ndarray] = None,
                       seed: int = 8527, op32=None,
                       op64=None, device_vectors: bool = False,
                       vec_rtol: Optional[float] = None,
                       op16=None) -> EighResult:
    """Mixed-precision eigensolver: f32 thick-restart Lanczos for the
    Krylov iterations (matmul throughput), then an f64 Rayleigh-Ritz
    expansion refine certifying the retained eigenVECTORS at
    ``vec_rtol`` (explicit residuals — the vectors feed Sigma, see
    :func:`_mixed_vec_rtol`).  Falls back to a warm-started full-f64
    solve at the caller's ``tol`` when the refine misses.
    ``device_vectors`` keeps the Krylov output and the refined Ritz pair
    planes device-resident."""
    f32_tol = max(tol, 2e-6)
    res32 = lanczos_eigh_split(matvec_pair32, dim, neigen=neigen, ncv=ncv,
                               maxiter=maxiter, tol=f32_tol, v0=v0,
                               seed=seed, dtype=jnp.float32, op=op32,
                               device_vectors=device_vectors, op16=op16)
    op32 = op16 = None          # see lanczos_eigh_mixed_real
    rtol = _mixed_vec_rtol(vec_rtol)
    if device_vectors:
        theta, vecs, resid = rayleigh_refine_split_device(
            matvec_pair64, res32.eigenvectors, neigen, op64=op64,
            rtol=rtol)
        nmv = res32.iterations + vecs[0].shape[0]
    else:
        mv64 = (matvec_pair64 if op64 is None
                else (lambda vr, vi: matvec_pair64(op64, vr, vi)))
        theta, vecs, resid = rayleigh_refine(mv64, res32.eigenvectors,
                                             neigen, rtol=rtol,
                                             max_expand=16)
        nmv = res32.iterations + len(res32.eigenvectors)
    # explicit-residual acceptance; polish in f64 at the caller's tol
    # if insufficient (ADVICE r3: keep ARPACK tol=0 semantics)
    ok = np.all(resid <= rtol * np.maximum(np.abs(theta), 1.0))
    if not ok:
        from ..utils.membudget import budget_bytes
        ncv_fb = min(ncv, max(neigen + 2,
                              int(budget_bytes(0.33) / (dim * 16)) - 1))
        v0_64 = ((np.asarray(vecs[0][0]) + 1j * np.asarray(vecs[1][0]))
                 if device_vectors else vecs[0])
        res64 = lanczos_eigh_split(matvec_pair64, dim, neigen=neigen,
                                   ncv=ncv_fb, maxiter=maxiter,
                                   tol=max(tol, _F64_TOL_FLOOR),
                                   v0=v0_64, seed=seed, op=op64,
                                   device_vectors=device_vectors)
        return EighResult(res64.eigenvalues, res64.eigenvectors,
                          nmv + res64.iterations, res64.converged)
    return EighResult(theta, vecs, nmv, True)


# ---------------------------------------------------------------------------
# ground-state plain Lanczos (lanc_method="lanczos", T=0 only)
# ---------------------------------------------------------------------------

def lanczos_gs(matvec: Callable, dim: int, maxiter: int = 512,
               tol: float = 1e-14, dtype=jnp.complex128,
               seed: int = 8527) -> EighResult:
    """Single lowest eigenpair via restarted plain Lanczos
    (sp_lanc_eigh semantics, ED_DIAG.f90:173-185)."""
    return lanczos_eigh(matvec, dim, neigen=1,
                        ncv=min(dim, max(8, min(32, maxiter))),
                        maxiter=maxiter, tol=tol, dtype=dtype, seed=seed)


# ---------------------------------------------------------------------------
# dense small-sector path (ED_DIAG.f90:194-218)
# ---------------------------------------------------------------------------

def dense_eigh(h: np.ndarray, neigen: Optional[int] = None):
    """LAPACK path for dim <= lanc_dim_threshold; returns all or first
    ``neigen`` pairs (vectors as rows)."""
    w, v = np.linalg.eigh(h)
    if neigen is not None:
        w, v = w[:neigen], v[:, :neigen]
    return w, v.T


def tridiag_eigh(alphas: np.ndarray, betas: np.ndarray):
    """Eigen-decomposition of the Lanczos tridiagonal (LAPACK stev
    equivalent; ED_GF_NORMAL.f90:953).  Returns (evals, first-row weights)."""
    m = len(alphas)
    if m == 0:
        return np.zeros(0), np.zeros(0)
    t = np.diag(alphas)
    if m > 1:
        t += np.diag(betas, 1) + np.diag(betas, -1)
    w, z = np.linalg.eigh(t)
    return w, z[0, :]
