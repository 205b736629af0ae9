from diff_qp_mpc_tpu_torch.models.base import (  # noqa: F401
    DynamicsModel,
    angle_normalize,
    step_with_jac,
)
from diff_qp_mpc_tpu_torch.models.pendulum import Pendulum  # noqa: F401
