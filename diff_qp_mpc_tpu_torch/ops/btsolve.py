"""Batched block-tridiagonal Cholesky factor/solve, plain PyTorch (port of
diff_qp_mpc_tpu.ops.btsolve). This is the plain version of the CUDA kernel
in ops/btsolve_cuda.py and the path CPU tensors take.

Factorization (lower block bidiagonal L), block size n = nx + nu:
    L₀L₀ᵀ = D₀ + reg·I;  Sₜ = Oₜ₋₁ Lₜ₋₁⁻ᵀ;  LₜLₜᵀ = Dₜ − SₜSₜᵀ + reg·I
with D the diagonal blocks and Oₜ = H[t+1, t] the subdiagonal blocks, then
block forward (L y = b) and backward (Lᵀ x = y) substitution.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _chol(M: Tensor) -> Tensor:
    """Batched lower Cholesky from the lower triangle of M. A matrix that is
    not positive definite factors to NaN, as the reference's does, instead
    of raising: the Newton line search rejects a NaN direction."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _tri(L: Tensor, v: Tensor, upper: bool) -> Tensor:
    """Solve L y = v (upper=False) or Lᵀ y = v (upper=True) for vectors v."""
    A = L.transpose(-1, -2) if upper else L
    return torch.linalg.solve_triangular(A, v[..., None], upper=upper)[..., 0]


def batched_factor_solve(D: Tensor, O: Tensor, b: Tensor,
                         reg: float = 0.0) -> Tensor:
    """D: [B, T, n, n], O: [B, T-1, n, n], b: [B, T, n] -> x: [B, T, n]."""
    T, n = D.shape[1], D.shape[-1]
    D = D + reg * torch.eye(n, dtype=D.dtype, device=D.device)
    Ls = [_chol(D[:, 0])]
    Ss = [None]
    for t in range(1, T):
        # S = O L_prev⁻ᵀ  <=>  L_prev Sᵀ = Oᵀ
        St = torch.linalg.solve_triangular(
            Ls[-1], O[:, t - 1].transpose(-1, -2), upper=False
        ).transpose(-1, -2)
        Ls.append(_chol(D[:, t] - St @ St.transpose(-1, -2)))
        Ss.append(St)
    ys = [_tri(Ls[0], b[:, 0], upper=False)]
    for t in range(1, T):
        ys.append(_tri(Ls[t], b[:, t] - (Ss[t] @ ys[-1][..., None])[..., 0],
                       upper=False))
    xs = [_tri(Ls[T - 1], ys[T - 1], upper=True)]
    for t in reversed(range(T - 1)):
        v = ys[t] - (Ss[t + 1].transpose(-1, -2) @ xs[0][..., None])[..., 0]
        xs.insert(0, _tri(Ls[t], v, upper=True))
    return torch.stack(xs, dim=1)


def to_dense(D: Tensor, O: Tensor) -> Tensor:
    """Assemble the dense [B, T·n, T·n] matrix from its blocks."""
    B, T, n, _ = D.shape
    H = D.new_zeros(B, T * n, T * n)
    for t in range(T):
        H[:, t * n:(t + 1) * n, t * n:(t + 1) * n] = D[:, t]
    for t in range(T - 1):
        H[:, (t + 1) * n:(t + 2) * n, t * n:(t + 1) * n] = O[:, t]
        H[:, t * n:(t + 1) * n, (t + 1) * n:(t + 2) * n] = \
            O[:, t].transpose(-1, -2)
    return H
