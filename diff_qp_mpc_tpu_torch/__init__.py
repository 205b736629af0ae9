"""diff_qp_mpc_tpu_torch — the PyTorch/CUDA port of diff_qp_mpc_tpu.

The JAX package ``diff_qp_mpc_tpu`` is the reference; this package runs
the same solvers and policies on an NVIDIA GPU, with the TPU's Pallas
kernels rewritten by hand in CUDA C++ (``csrc/``). Sub-packages mirror the
reference's: ``core``, ``models``, ``ops``, ``solvers``, ``learning``,
``envs``, ``utils``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no such request they raise instead of falling back.
"""
import torch

# The block-tridiagonal Cholesky is only SPD-stable at full float32
# accumulation: the reference pins ``Precision.HIGHEST`` on every matmul
# after reduced-precision products broke the factorization. TF32 keeps ~10
# mantissa bits, so it is switched off for matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from diff_qp_mpc_tpu_torch.core.types import (  # noqa: E402,F401
    ALState,
    Bounds,
    DiagQuadCost,
    Lambdas,
    SolveStats,
)
from diff_qp_mpc_tpu_torch.utils.device import resolve_device  # noqa: E402,F401
