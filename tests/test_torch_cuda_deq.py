"""The rest of the DEQ network family on the card against the CPU: the conv
DEQ-MPC policy (K2 forward, K1 backward), NNMPCPolicy (one K2 and one K1 a
call), DEQPolicy and NNPolicy (no kernel), float64, with the launch counts.

This file imports no JAX, so it runs on the GPU machine:

    python -m pytest -p no:xdist -p no:cacheprovider -o addopts="" \\
        -m cuda tests/test_torch_cuda_deq.py

Without a CUDA device every test skips. Tolerances, relative to each
quantity's largest entry: 1e-6 through an AL solve (the line search's
near-ties, as chip_smoke.py's POLICY_TOL and GRAD_TOL), 1e-9 on the
networks alone (chip_smoke.py's DEQ_NET_TOL)."""
import pytest
import torch

from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning import deq, losses, train
from diff_qp_mpc_tpu_torch.learning.policies import NNMPCPolicy
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, btsolve_cuda

pytestmark = pytest.mark.cuda
F64 = torch.float64
SOLVE_TOL, NET_TOL = 1e-6, 1e-9
B, T = 8, 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def _counts():
    return al_fused_cuda.launches, btsolve_cuda.launches


def _x(seed=0):
    return make_env("pendulum")._sample_init(
        torch.Generator().manual_seed(seed), B).to(F64)


def _twins(make):
    """The same seeded module on the CPU and on the card, float64."""
    torch.manual_seed(0)
    cpu = make().to(F64)
    card = make().to(F64)
    card.load_state_dict(cpu.state_dict())
    return cpu, card.cuda()


def _argv(*extra):
    return ["--env", "pendulum", "--deq", "--deq_iter", "2", "--T", str(T),
            "--hdim", "16", "--qp_iter", "2", "--fused", "--qp_solve",
            "--deq_out_type", "2", "--policy_out_type", "2", *extra]


def test_conv_deqmpc_policy_card_vs_cpu(cuda):
    """The conv DEQ-MPC policy on the fused path: 2 K2 launches a forward
    (deq_iter 2, fresh solves), 2 K1 in the training loss's backward; every
    iterate and the gradient within 1e-6 of the CPU's."""
    args = train.build_parser().parse_args(_argv("--layer_type", "conv"))
    env = make_env("pendulum")
    cpu, card = _twins(lambda: train.make_policy(args, env))
    assert card.layer.layer_type == "conv"
    x = _x()
    gt = _x(1)[:, None].expand(B, T, 2).contiguous()
    out = {}
    for name, pol, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        before = _counts()
        its, _ = pol(x.to(dev))
        fwd = tuple(a - b for a, b in zip(_counts(), before))
        loss = losses.compute_loss_deqmpc(
            1, gt.to(dev), torch.zeros(B, T, 1, dtype=F64, device=dev),
            torch.ones(B, T, dtype=F64, device=dev), its)[0]
        g = torch.autograd.grad(loss, list(pol.parameters()))
        back = tuple(a - b for a, b in zip(_counts(), before))
        out[name] = (its, torch.cat([v.reshape(-1) for v in g]), fwd, back)
    assert out["cpu"][2:] == ((0, 0), (0, 0))
    assert out["card"][2] == (2, 0) and out["card"][3] == (2, 2)
    for a, b in zip(out["card"][0], out["cpu"][0]):
        for field in ("net_states", "states", "actions"):
            assert _rel(getattr(a, field), getattr(b, field)) <= SOLVE_TOL
    assert _rel(out["card"][1], out["cpu"][1]) <= SOLVE_TOL


def test_nnmpc_policy_one_k2_one_k1_a_call(cuda):
    """NNMPCPolicy on the fused tracker: exactly one K2 launch a forward
    and one K1 in its backward; actions and gradient card vs CPU."""
    env = make_env("pendulum")
    tracking = train.make_policy(train.build_parser().parse_args(_argv()),
                                 env).tracking
    cpu, card = _twins(lambda: NNMPCPolicy(2, 1, 1, T, 32, tracking))
    x = _x()
    out = {}
    for name, pol, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        before = _counts()
        s, a = pol(x.to(dev))
        fwd = tuple(c - b for c, b in zip(_counts(), before))
        g = torch.autograd.grad((s ** 2).sum() + (a ** 2).sum(),
                                list(pol.parameters()))
        back = tuple(c - b for c, b in zip(_counts(), before))
        out[name] = (a, torch.cat([v.reshape(-1) for v in g]), fwd, back)
    assert out["card"][2:] == ((1, 0), (1, 1))
    assert _rel(out["card"][0], out["cpu"][0]) <= SOLVE_TOL
    assert _rel(out["card"][1], out["cpu"][1]) <= SOLVE_TOL


@pytest.mark.parametrize("net", ["deq_policy", "nn0", "nn1", "nn2", "nn3",
                                 "ffd"])
def test_networks_card_vs_cpu_launch_nothing(cuda, net):
    """DEQPolicy (the Anderson fixed point and its implicit backward),
    NNPolicy at each out_type and FFDNetwork: outputs and gradient card
    vs CPU within 1e-9, no kernel launched."""
    make = {"deq_policy": lambda: deq.DEQPolicy(nx=2, T=T, hdim=32),
            "ffd": lambda: deq.FFDNetwork(nx=4, nq=2, T=T, hdim=32)}.get(
        net, lambda: deq.NNPolicy(4, 1, 2, T, 32, 0.05,
                                  out_type=int(net[-1])))
    cpu, card = _twins(make)
    nx = 2 if net == "deq_policy" else 4
    x = torch.rand(B, nx, dtype=F64, generator=torch.Generator()
                   .manual_seed(3)) * 2 - 1
    before = _counts()
    out = {}
    for name, pol, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        outs = pol(x.to(dev))
        outs = [o for o in (outs if isinstance(outs, tuple) else (outs,))
                if o is not None]
        g = torch.autograd.grad(sum((o ** 2).sum() for o in outs),
                                list(pol.parameters()))
        out[name] = (outs, torch.cat([v.reshape(-1) for v in g]))
    assert _counts() == before
    for a, b in zip(out["card"][0], out["cpu"][0]):
        assert _rel(a, b) <= NET_TOL
    assert _rel(out["card"][1], out["cpu"][1]) <= NET_TOL


def test_bc_train_step_launches_nothing(cuda):
    """One BC training step (no --deq) on the card: no kernel launched,
    the loss and the updated parameters within 1e-9 of the CPU's."""
    args = train.build_parser().parse_args(
        ["--env", "pendulum", "--T", str(T), "--hdim", "32",
         "--policy_out_type", "2", "--grad_clip", "0.5"])
    env = make_env("pendulum")
    cpu, card = _twins(lambda: train.make_policy(args, env))
    assert isinstance(card, deq.NNPolicy)
    g = torch.Generator().manual_seed(4)
    batch = {"state": torch.rand(B, T, 2, dtype=F64, generator=g),
             "action": torch.rand(B, T, 1, dtype=F64, generator=g),
             "mask": torch.ones(B, T, dtype=F64)}
    before = _counts()
    losses_ = []
    for pol, dev in ((cpu, "cpu"), (card, cuda)):
        adam = train.Adam(dict(pol.named_parameters()), args.lr)
        step = train.make_train_step(pol, adam, args, torch.Generator())
        losses_.append(step({k: v.to(dev) for k, v in batch.items()},
                            False)[0])
    assert _counts() == before
    assert _rel(losses_[1], losses_[0]) <= NET_TOL
    for k, v in cpu.state_dict().items():
        assert _rel(card.state_dict()[k], v) <= NET_TOL, k
