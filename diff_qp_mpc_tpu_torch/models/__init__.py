from diff_qp_mpc_tpu_torch.models.base import (  # noqa: F401
    DynamicsModel,
    Functor,
    Rk4Functor,
    angle_normalize,
    angle_normalize_2pi,
    euler,
    linearize_trajectory,
    midpoint,
    rk4,
    rk4_parts,
    semi_implicit_euler,
    step_with_jac,
)
from diff_qp_mpc_tpu_torch.models.cartpole import (  # noqa: F401
    Cartpole1L,
    Cartpole2L,
    CartpoleCosSin,
)
from diff_qp_mpc_tpu_torch.models.integrator import Integrator  # noqa: F401
from diff_qp_mpc_tpu_torch.models.lagrangian import (  # noqa: F401
    lagrangian_ode,
    manipulator_accel,
)
from diff_qp_mpc_tpu_torch.models.pendulum import (  # noqa: F401
    Pendulum,
    PendulumCosSin,
)
from diff_qp_mpc_tpu_torch.models.quadrotor import RexQuadrotor  # noqa: F401
from diff_qp_mpc_tpu_torch.models import rotation  # noqa: F401,E402
