"""Operation and byte counts of the port's kernels, and the H100 peaks that
turn them into bounds (port of benchmarks/flops.py).

Two kinds of count live here:

- the algorithmic counts of the repo-root ``benchmarks/flops.py``
  (``fused_al_flops``, ``btsolve_flops``, ``riccati_flops``,
  ``bytes_per_solve``), unchanged: useful math of the textbook algorithm,
  multiply and add counted separately;
- the counts of what the CUDA sources execute (``k1_ops`` … ``k4_ops``,
  ``k2_sin_evals``, the ``k*_bytes``), which give the bounds in PERF.md:
  a multiply-add is 2 operations, a divide or square root 1, a compare or
  select 0; bytes are each input read once and each output written once.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3.
One FP32 instruction per lane per clock is half the FLOP rate (a fused
multiply-add is 2 FLOPs in one instruction).
"""
from __future__ import annotations

from typing import Tuple

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
#: FP32 instructions of one ``sin(float)`` on its fast path (|x| below
#: ~1e5, no --use_fast_math), read once from the SASS that CUDA 12.8's
#: cuobjdump printed for sm_90a (tests/data/sinf_probe_sm90a.sass): 9 FFMA,
#: 2 FMUL, 3 FSEL, 1 FSETP, of 26 instructions in all; the slow Payne-Hanek
#: reduction is branched over. Another toolkit may compile it otherwise.
SINF_FP32_INSTR = 15

# per-coordinate cost of one dynamics step evaluation (pendulum-class
# closed forms: a few transcendentals + muls; transcendentals counted as 8)
_STEP_FLOPS_PER_COORD = 12


# ------------------------------------------- algorithmic counts (JAX) ----
def _chol_flops(n: int) -> float:
    """Cholesky of an n×n SPD matrix (n³/3) + two triangular solves (2n²)."""
    return n ** 3 / 3 + 2 * n ** 2


def fused_al_flops(T: int, nx: int, nu: int, al_iter: int, n_newton: int,
                   n_ls: int) -> float:
    """FLOPs per solve of the whole-solver fused AL kernel: AL outer loop ×
    (Newton: Jacobian + GN Hessian assembly, block-tridiagonal factor+solve,
    batched 2⁻ᵏ line search) + multiplier updates."""
    n = nx + nu
    jac = nx * (nx + nu) * _STEP_FLOPS_PER_COORD  # jvp-per-input-dim
    hess_blocks = 6 * n * n * nx                   # ρJᵀJ + cost diag, D and O
    grad = 4 * n * nx + 2 * n                      # merit gradient terms
    factor = T * (_chol_flops(n) + 2 * n ** 3)     # block factor incl. off-diag
    solve = T * 4 * n ** 2
    rollout = T * nx * _STEP_FLOPS_PER_COORD
    merit = T * (4 * n + 3 * nx + 2 * nx * _STEP_FLOPS_PER_COORD)
    newton = T * (jac + hess_blocks + grad) + factor + solve \
        + n_ls * (rollout + merit)
    lam_upd = T * (13 * nx + 6 * nu)
    return al_iter * (n_newton * newton + lam_upd)


def btsolve_flops(T: int, n: int) -> float:
    """Block-tridiagonal Cholesky factor+solve per batch element."""
    return T * (_chol_flops(n) + 2 * n ** 3 + 4 * n ** 2)


def riccati_flops(T: int, nx: int, nu: int) -> float:
    """Sequential Riccati backward+forward per batch element: per stage ~6
    matmuls nx³-class + Quu Cholesky + gain solves."""
    return T * (6 * nx ** 3 + 4 * nx ** 2 * nu + 2 * nx * nu ** 2
                + _chol_flops(nu) + 2 * nu ** 2 * nx + 6 * nx ** 2)


def bytes_per_solve(T: int, nx: int, nu: int) -> float:
    """HBM traffic per solve of the fused kernel (f32): read cost (Cd, c),
    x0, inits; write solution + residual."""
    n = nx + nu
    return 4.0 * (2 * T * n + nx + T * n + T * nu + T * n + 1)


# ------------------------------------------------ bound on the card ----
def bound(nbytes: float, nops: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of bytes over the HBM rate
    and operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------- counts of the CUDA sources ----
def k1_ops(T_, n):
    """Floating-point operations of one element's factor + solve, counted
    from csrc/btsolve.cu (a multiply-subtract is 2, a divide or sqrt 1)."""
    chol = sum(2 * j + 1 for i in range(n) for j in range(i + 1))
    lower_mat = n ** 3
    schur = n * n * (n + 1) + n
    tri = n * n  # one triangular vector solve
    stage0 = n + chol + tri
    stage = lower_mat + schur + chol + 2 * n * n + tri
    backward = tri + (T_ - 1) * (2 * n * n + tri)
    return stage0 + (T_ - 1) * stage + backward


class _Counted:
    """A number that counts the arithmetic done on it (an operation each,
    negation none; sin and cos apart) and nothing else."""

    ops = 0
    sins = 0

    def _op(self, *_):
        _Counted.ops += 1
        return _Counted()

    __add__ = __radd__ = __sub__ = __rsub__ = _op
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _op

    def __neg__(self):
        return _Counted()

    def sin(self):
        _Counted.sins += 1
        return _Counted()

    cos = sin

    def atan2(self, other):
        """One transcendental evaluation, as a sin (its fast path is
        longer than a sin's, so the bound stays a lower bound)."""
        return self.sin()

    def clip(self, lo, hi):  # two compares and selects
        return _Counted()

    def sign(self):  # a compare and a select
        return _Counted()


def _counted(fn):
    """(operations, sin and cos evaluations) of ``fn()``."""
    _Counted.ops = _Counted.sins = 0
    fn()
    return _Counted.ops, _Counted.sins


def functor_counts(model) -> Tuple[int, int, int, int]:
    """(step, Jacobian, step sins, Jacobian sins) of K2's functor of a
    cartpole, a CosSin model or the quadrotor (``csrc/al_fused_cartpole*``,
    ``al_fused_cossin.cu``, ``al_fused_quadrotor.cu``), counted by running
    its plain
    version, ``model.step_parts``, which does the functor's operations one
    for one, on counting numbers: the step on values, the Jacobian as one
    pass on duals per input column (``models.dual``; a dual times a
    constant is 2 operations, a dual product 4, a dual sin a sin, a cos
    and a product). Operations include the sin and cos evaluations, as
    ``k2_ops`` counts them."""
    from diff_qp_mpc_tpu_torch.models.dual import Dual

    nx, n = model.nx, model.nx + model.nu
    p = {k: _Counted() for k in model.PARAMS}
    vals = [_Counted() for _ in range(n)]
    step, step_sins = _counted(
        lambda: model.step_parts(vals[:nx], vals[nx:], p))
    duals = [Dual(_Counted(), _Counted()) for _ in range(n)]
    col, col_sins = _counted(
        lambda: model.step_parts(duals[:nx], duals[nx:], p))
    return step + step_sins, n * (col + col_sins), step_sins, n * col_sins


def _k2_model_counts(model: str) -> Tuple[int, int, int, int]:
    """(step, Jacobian, step sins, Jacobian sins) of K2's functor of
    ``model`` (a name of ``K2_MODELS``)."""
    if model == "pendulum":
        # csrc/al_fused.cu's PendulumDyn, counted by hand: the step 8 with
        # its sin, the Jacobian 9 with its cos
        return 8, 9, 1, 1
    if model == "integrator":
        # IntegratorDyn: two multiply-adds; the Jacobian's dt·dt
        return 4, 1, 0, 0
    from diff_qp_mpc_tpu_torch.models import (
        Cartpole1L,
        Cartpole2L,
        CartpoleCosSin,
        PendulumCosSin,
        RexQuadrotor,
    )

    return functor_counts({"cartpole1l": Cartpole1L,
                           "cartpole2l": Cartpole2L,
                           "quadrotor": RexQuadrotor,
                           "pendulum_cossin": PendulumCosSin,
                           "cartpole_cossin": CartpoleCosSin}[model]())


#: the models K2 is built for, by the name ``ops.al_fused_cuda`` gives them
K2_MODELS = ("pendulum", "integrator", "cartpole1l", "cartpole2l",
             "quadrotor", "pendulum_cossin", "cartpole_cossin")


def k2_ops(T_, nx, nu, al_iter, n_newton, n_ls, model="pendulum"):
    """Floating-point operations of one element's solve, counted from
    csrc/al_fused_common.cuh with ``model``'s functor (its step and
    Jacobian from ``_k2_model_counts``; a multiply-add is 2, a compare or
    select 0, a sin or cos 1). The quadrotor's warp layout
    (csrc/al_fused_warp.cuh) does the same arithmetic in other orders."""
    n = nx + nu
    step, jac = _k2_model_counts(model)[:2]
    dyn_terms = (T_ - 1) * (step + nx * 7)  # r, λr, ρ/2 r²
    bound_terms = T_ * nu * 14
    constraints = dyn_terms + bound_terms
    cost_terms = T_ * n * 5
    grad = ((T_ - 1) * (step + jac + nx * 3) + T_ * n * 2
            + (T_ - 1) * (2 * nx * nx + 2 * nu * nx + nx) + T_ * nu * 10)
    gtg = n * (n + 1) // 2 * (2 * nx + 2)
    build = T_ * (n + nx + 2 * nu) + (T_ - 1) * (gtg + 2 * nx * n)
    newton = (grad + build + k1_ops(T_, n) + T_ * n + T_ * n * 11
              + n_ls * (2 * T_ * n + constraints + 5) + 2 * T_ * n)
    al_update = (T_ - 1) * (step + nx * 3) + T_ * nu * 6 + 2
    per_al = constraints + cost_terms + n_newton * newton + al_update
    residual = (T_ - 1) * (step + nx * 3) + T_ * nu * 6 + 1
    return al_iter * per_al + residual


def k2_sin_evals(T_, al_iter, n_newton, n_ls, model="pendulum"):
    """sin and cos evaluations of one element's solve in
    csrc/al_fused_common.cuh (the pendulum: one sin per step(), one cos per
    jac()): per AL iteration the merit (T−1 steps), n_newton × (T−1 steps +
    T−1 Jacobians + n_ls line-search merits of T−1 steps each) and the λ
    update (T−1 steps); then the output residual (T−1 steps)."""
    _, _, step, jac = _k2_model_counts(model)
    per_al = (T_ - 1) * (step * (2 + n_newton * (1 + n_ls))
                         + jac * n_newton)
    return al_iter * per_al + (T_ - 1) * step


def k2_ops_with_sin(T_, nx, nu, al_iter, n_newton, n_ls, sin_fp32_instr,
                    model="pendulum"):
    """k2_ops with each sin or cos counted as the ``sin_fp32_instr`` FP32
    instructions of its fast path (2 operations each at the float32 peak,
    the FLOP rate being two per instruction) instead of 1."""
    sins = k2_sin_evals(T_, al_iter, n_newton, n_ls, model)
    return (k2_ops(T_, nx, nu, al_iter, n_newton, n_ls, model) - sins
            + 2 * sin_fp32_instr * sins)


def _mm_ops(r, k, c):
    """Operations of an r×k by k×c product: a first product, then k−1
    multiply-adds of 2 per entry."""
    return r * c * (2 * k - 1)


def k3_ops(T_, nx, nu):
    """Floating-point operations of one element's Riccati solve, counted
    from csrc/riccati_common.cuh (a multiply-add is 2, a divide or sqrt 1,
    a negation 0)."""
    chol = sum(2 * j + 1 for i in range(nu) for j in range(i + 1))
    dyn = (_mm_ops(nx, nx, nx) + _mm_ops(nx, nx, nu) + _mm_ops(nx, nx, 1)
           + nx  # PA, PB, m = P r + p
           + _mm_ops(nx, nx, nx) + nx * nx + _mm_ops(nx, nx, nu) + nx * nu
           + _mm_ops(nu, nx, nu) + nu * nu  # Qxx, Qxu, Quu
           + _mm_ops(nx, nx, 1) + nx + _mm_ops(nu, nx, 1) + nu)  # qx, qu
    stage = (nu + chol + (nx + 1) * 2 * nu * nu  # reg, Cholesky, K and k
             + _mm_ops(nx, nu, nx) + nx * nx + nx * (nx - 1)  # P, symmetrize
             + _mm_ops(nx, nu, 1) + nx)  # p
    fwd = _mm_ops(nu, nx, 1) + nu + _mm_ops(nx, nx, 1) + nx  # du, λ
    fwd_dyn = _mm_ops(nx, nx, 1) + _mm_ops(nx, nu, 1) + 2 * nx
    return (T_ - 1) * dyn + T_ * stage + T_ * fwd + (T_ - 1) * fwd_dyn


def k4_ops(T_, nx, nu, max_iter):
    """Floating-point operations of one element's IPM, counted as k3_ops
    counts (a compare or select 0), with each term divided where the plain
    version (``fused_trajqp_solve_reference``) divides it: the function's
    work. csrc/trajqp_fused.cu replaces most of those divisions by
    multiplies with reciprocals (one a slack, one a ratio test, one a
    Riccati stage at one control), which changes the count by under 2%."""
    resid = (T_ * nx * (2 * nx + 2 * nu) + T_ * nu * (2 + 2 * nx + 2 * nu)
             + (T_ - 1) * (nx * (2 * nx + 1) + nu * 2 * nx) + nx
             + (T_ - 1) * nx * (1 + 2 * nx + 2 * nu) + nx + 6 * T_ * nu)
    norm = (2 * T_ * nu + 1
            + 2 * ((T_ - 1) * nx + nx + 2 * T_ * nu + T_ * nx + T_ * nu)
            + 6 + 9)  # squares, six square roots, the sums
    kkt = 12 * T_ * nu + k3_ops(T_, nx, nu) + 8 * T_ * nu
    step = 2 * 4 * T_ * nu  # divide and minimum per (v, dv) pair
    per_iter = (resid + norm + 2 * kkt + 2 * step + 1
                + 10 * T_ * nu + 1 + 5  # μ_aff, σμ
                + 4 * T_ * nu + T_ * (2 * nx + 5 * nu)  # corrector rhs, sum
                + T_ * (4 * nx + 14 * nu))  # the update and clamps
    return max_iter * per_iter + resid + norm


def k1_bytes(T_, n):
    """D, O and b read, x written (float32, as every k*_bytes)."""
    return 4 * (T_ * n * n + (T_ - 1) * n * n + 2 * T_ * n)


def k2_bytes(T_, nx, nu):
    """Cd, c, x0, x/u inits, λ_dyn, λ_hi/λ_lo and ρ read; xu, the three
    multipliers and the residual written."""
    n = nx + nu
    ins = (2 * T_ * n + nx + T_ * nx + T_ * nu + (T_ - 1) * nx + 2 * T_ * nu
           + 1)
    outs = T_ * n + (T_ - 1) * nx + 2 * T_ * nu + 1
    return 4 * (ins + outs)


def k3_bytes(T_, nx, nu):
    """The stage blocks, gradients, dynamics and dx0 read; dx, du, λ
    written."""
    ins = (T_ * (nx * nx + nx * nu + nu * nu + nx + nu)
           + (T_ - 1) * (nx * nx + nx * nu + nx) + nx)
    outs = T_ * (2 * nx + nu)
    return 4 * (ins + outs)


def k4_bytes(T_, nx, nu):
    """C, c, A, B, f, x0 and the x/u inits read; x, u, λ, z, s and the
    residual written."""
    n = nx + nu
    ins = (T_ * n * n + T_ * n + (T_ - 1) * (nx * nx + nx * nu + nx) + nx
           + T_ * n)
    outs = T_ * (2 * nx + 5 * nu) + 1
    return 4 * (ins + outs)


def k5_bytes(n_tiles, n_streams):
    """x [n_tiles, n_streams, 8, 128] read, out [n_tiles, 8, 128] written,
    float32."""
    return 4 * n_tiles * 1024 * (n_streams + 1)


def k5_ops(n_tiles, n_streams, n_ops, sin_fp32_instr):
    """Float32 operations of the sin chain at the peak's rate: each sin is
    ``sin_fp32_instr`` FP32 instructions, 2 operations each (the FLOP rate
    is two per instruction), plus the n_streams − 1 adds per element."""
    elements = n_tiles * 1024
    return elements * (n_streams * n_ops * 2 * sin_fp32_instr
                       + (n_streams - 1))
