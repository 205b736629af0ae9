"""The rest of the DEQ network family (diff_qp_mpc_tpu_torch.learning.deq:
the conv cell, out_types 0, 3 and 4, anderson, deq_fixed_point, DEQPolicy;
DEQMPCPolicy with the conv cell; the reference-checkpoint adapter) against
the JAX package's, from flax-initialised weights mapped by params_from_flax
and inputs drawn from numpy seeds.

The JAX side runs jitted, once per case in float64 (functools.lru_cache),
and the port runs each case in float64 and in float32 against it.
Tolerances, relative to each quantity's largest entry: float64 1e-10 on the
networks (the same arithmetic in another order), 1e-9 on DEQPolicy's
gradient (the acceptance bound for the implicit backward) and 1e-6 where an
AL solve is inside (the line search's near-ties, as
test_torch_policy_variants.py); float32 1e-4 on the networks and 1e-2
through a solve (an AL solve, or the Anderson solve of DEQPolicy's
backward).
"""
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import assert_flax_grads, load_flax, npy, rel_err
from diff_qp_mpc_tpu.learning import deq as jdeq
from diff_qp_mpc_tpu_torch.learning import deq
from diff_qp_mpc_tpu_torch.utils.checkpoint import (
    dumps,
    params_from_flax,
    params_to_flax,
)

NX, NU, NQ, T, H, DT, B = 3, 1, 1, 5, 16, 0.1, 4
DTYPES = {"f64": (torch.float64, 1e-10), "f32": (torch.float32, 1e-4)}
SOLVE_TOL = {"f64": 1e-6, "f32": 1e-2}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _init64(module, seed, *args, **kwargs):
    """A flax module's initial parameters, cast to float64."""
    return jax.tree.map(lambda a: a.astype(jnp.float64), module.init(
        jax.random.PRNGKey(seed), *args, **kwargs))


# ------------------------------------------------------------ DEQLayer ----
LAYER_CASES = [("conv", o) for o in range(5)] + [("mlp", o) for o in (0, 3, 4)]


def _layer_inputs(jlayer, layer_type, seed):
    """x, the flattened estimate and z: the conv cell reads the estimate's
    first T·nx entries, so at out_type 0 (in_dim T·nu) it is given T·nx."""
    rng = np.random.RandomState(seed)
    width = jlayer.in_dim() if layer_type == "mlp" else max(
        jlayer.in_dim(), T * NX)
    zshape = (B, T, H) if layer_type == "conv" else (B, H)
    return rng.randn(B, NX), rng.randn(B, width), 0.5 * rng.randn(*zshape)


@functools.lru_cache(maxsize=None)
def _jax_layer(layer_type, out_type):
    """The flax layer's float64 parameters, inputs, the weights of a fixed
    linear functional of (trajectory, z), and its jitted forward and
    jax.grad w.r.t. the parameters and z."""
    jl = jdeq.DEQLayer(nx=NX, nu=NU, nq=NQ, T=T, hdim=H, dt=DT,
                       out_type=out_type, layer_type=layer_type)
    x, traj, z = _layer_inputs(jl, layer_type, out_type)
    params = _init64(jl, out_type, x, traj, z)
    rng = np.random.RandomState(10 + out_type)
    out_shape = jax.eval_shape(jl.apply, params, x, traj, z)
    w_out, w_z = (rng.randn(*s.shape) for s in out_shape)

    def loss(p, zz):
        out, z_out = jl.apply(p, x, traj, zz)
        return jnp.sum(out * w_out) + jnp.sum(z_out * w_z), (out, z_out)

    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, z)
    return params, (x, traj, z), (w_out, w_z), outs, grads


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("layer_type,out_type", LAYER_CASES)
def test_deq_layer_matches_flax(layer_type, out_type, dt):
    """Forward (the trajectory and z) and jax.grad of a fixed linear
    functional of both, w.r.t. every parameter and z."""
    dtype, tol = DTYPES[dt]
    params, (x, traj, z), (w_out, w_z), (jout, jz), (jg, jgz) = _jax_layer(
        layer_type, out_type)
    layer = load_flax(deq.DEQLayer(NX, NU, NQ, T, H, DT, out_type=out_type,
                               layer_type=layer_type), params, dtype)
    tz = torch.tensor(z, dtype=dtype, requires_grad=True)
    out, z_out = layer(torch.tensor(x, dtype=dtype),
                       torch.tensor(traj, dtype=dtype), tz)
    assert tuple(z_out.shape) == tuple(layer.init_z(B).shape)
    (out * torch.tensor(w_out, dtype=dtype)).sum().add(
        (z_out * torch.tensor(w_z, dtype=dtype)).sum()).backward()
    assert rel_err(out, jout) <= tol and rel_err(z_out, jz) <= tol
    assert rel_err(tz.grad, jgz) <= tol
    assert_flax_grads(layer, jg, tol)


def test_conv_layer_names_come_from_flax_init():
    """Every flax path the conv layer's mapping names exists in a real
    init tree, every leaf of that tree is named, and the shapes agree."""
    jl = jdeq.DEQLayer(nx=NX, nu=NU, nq=NQ, T=T, hdim=H, dt=DT,
                       out_type=2, layer_type="conv")
    x, traj, z = _layer_inputs(jl, "conv", 0)
    tree = _np_tree(jl.init(jax.random.PRNGKey(0), x, traj, z))["params"]
    layer = deq.DEQLayer(NX, NU, NQ, T, H, DT, out_type=2, layer_type="conv")
    state = params_from_flax(tree, layer.flax_modules())
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in layer.state_dict().items()}
    leaves = jax.tree_util.tree_leaves(tree)
    assert sum(v.size for v in leaves) == sum(
        v.numel() for v in state.values())
    # flax's kernel layouts: Dense [in, out], Conv [width, in, out]
    assert tree["DEQConvCell_0"]["Conv_0"]["kernel"].shape == (3, H, 4 * H)
    assert tree["DEQConvCell_0"]["Conv_2"]["kernel"].shape == (1, 4 * H, H)


def test_conv_layer_starts_from_flax_distributions():
    """Conv kernels lecun_normal over fan_in = width × in channels, zero
    biases, GroupNorm scale 1, time_emb normal(0.02)."""
    torch.manual_seed(0)
    layer = deq.DEQLayer(2, 1, 1, 5, 128, 0.05,
                         layer_type="conv").requires_grad_(False)
    convs = [m for m in layer.modules() if isinstance(m, torch.nn.Conv1d)]
    assert len(convs) == 3
    for m in convs:
        target = 1.0 / np.sqrt(m.in_channels * m.kernel_size[0])
        assert abs(float(m.weight.std()) / target - 1.0) < 0.05
        assert float(m.weight.abs().max()) <= 2 * target / deq._TRUNC_STD
        assert float(m.bias.abs().max()) == 0.0
    for m in layer.modules():
        if isinstance(m, torch.nn.GroupNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
    assert abs(float(layer.time_emb.std()) / 0.02 - 1.0) < 0.1


# ------------------------------------------------------------ anderson ----
@functools.lru_cache(maxsize=None)
def _jax_anderson(zshape):
    """A contraction z ↦ tanh(zA + b), z0, and JAX's float64 iterate and
    residual history at max_iter 12 over m 5 slots (the slots wrap)."""
    rng = np.random.RandomState(len(zshape))
    d = int(np.prod(zshape[1:]))
    A = 0.6 * rng.randn(d, d) / np.sqrt(d)
    b, z0 = rng.randn(d), rng.randn(*zshape)

    def jf(z):
        return jnp.tanh(z.reshape(z.shape[0], -1) @ A + b).reshape(z.shape)

    jz, jres = jax.jit(lambda z: jdeq.anderson(jf, z, max_iter=12))(z0)
    return A, b, z0, np.asarray(jz), np.asarray(jres)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("zshape", [(B, 6), (B, 3, 4)], ids=["flat", "3d"])
def test_anderson_matches_jax(zshape, dt):
    """The returned iterate and the residual history, z0 of either rank."""
    dtype, tol = DTYPES[dt]
    A, b, z0, jz, jres = _jax_anderson(zshape)
    tA, tb = torch.tensor(A, dtype=dtype), torch.tensor(b, dtype=dtype)

    def tf(z):
        return torch.tanh(z.reshape(z.shape[0], -1) @ tA + tb).reshape(
            z.shape)

    z, res = deq.anderson(tf, torch.tensor(z0, dtype=dtype), max_iter=12)
    assert z.shape == zshape and res.shape == (12,)
    assert rel_err(z, jz) <= tol
    np.testing.assert_allclose(npy(res), jres, rtol=tol * 100, atol=tol)
    assert float(res[0]) == float(res[1]) == 0.0 and float(res[-1]) < 1e-2


# ----------------------------------------------------------- DEQPolicy ----
def test_deq_policy_forward_and_gradient_match_jax():
    """DEQPolicy's forward and jax.grad (the custom VJP: h* solved at z* =
    f(anderson iterate), (∂f/∂θ)ᵀh* for the cell and, through the hoisted
    input encoding, the encoder). float64: the gradient within 1e-9.
    float32: the forward within 1e-4; the gradient, an Anderson solve of
    the backward fixed point whose (m+1)² systems float32 rounds, within
    1e-2 (JAX's own float32 gradient reads up to 2.8e-3 from its float64
    one, the port's 4.9e-3)."""
    jp = jdeq.DEQPolicy(nx=2, T=4, hdim=16, fwd_iter=10)
    rng = np.random.RandomState(5)
    x = rng.uniform(-1.0, 1.0, (3, 2))
    w = rng.randn(3, 4, 2)
    params = _init64(jp, 1, x)

    def loss(p):
        out = jp.apply(p, x)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    for dt, gtol in (("f64", 1e-9), ("f32", 1e-2)):
        dtype, tol = DTYPES[dt]
        pol = load_flax(deq.DEQPolicy(nx=2, T=4, hdim=16, fwd_iter=10), params,
                    dtype)
        out = pol(torch.tensor(x, dtype=dtype))
        (out * torch.tensor(w, dtype=dtype)).sum().backward()
        assert rel_err(out, jout) <= tol, dt
        assert_flax_grads(pol, jg, gtol)
        # the encoder's gradient flows only through the fixed point's input
        assert float(pol.inp.weight.grad.abs().max()) > 0


def test_fixed_point_backward_linearizes_at_z_star():
    """The backward solves h = (∂f/∂z)ᵀh + ḡ with f linearized at z* =
    f(anderson iterate). Rebuilt here by hand, it gives the cell's gradient
    exactly at z*, and a different one (a hook at the iterate) when
    linearized at the Anderson iterate itself, which fwd_iter 3 leaves
    short of the fixed point."""
    torch.manual_seed(0)
    pol = deq.DEQPolicy(nx=2, T=4, hdim=16, fwd_iter=3).double()
    x = torch.tensor(np.random.RandomState(2).uniform(-1, 1, (3, 2)))
    w = torch.tensor(np.random.RandomState(3).randn(3, 4, 2))
    (pol(x) * w).sum().backward()
    got = [p.grad for p in pol.cell.parameters()]
    xinp = pol.inp_ln(pol.inp(x)).detach()
    f = lambda z: pol.cell(xinp, z)
    with torch.no_grad():
        z_iter, _ = deq.anderson(f, pol.init_z(x), max_iter=3)
        z_star = f(z_iter)
    zs = z_star.clone().requires_grad_(True)
    gbar = torch.autograd.grad(
        ((pol.out(zs).reshape(-1, 4, 2) + 10 * x[:, None]) * w).sum(), zs)[0]

    def cell_grads(at):
        z = at.clone().requires_grad_(True)
        fz = f(z)
        h, _ = deq.anderson(lambda h: torch.autograd.grad(
            fz, z, h, retain_graph=True)[0] + gbar, gbar)
        return torch.autograd.grad(fz, list(pol.cell.parameters()), h)

    assert all(torch.equal(a, b) for a, b in zip(cell_grads(z_star), got))
    hook = cell_grads(z_iter)
    assert max(rel_err(a, npy(b)) for a, b in zip(hook, got)) > 1e-3


# ---------------------------------------------- DEQMPCPolicy, conv cell ----
def _argv(out_type, extra=()):
    return ["--env", "pendulum", "--deq", "--deq_iter", "2", "--hdim",
            "16", "--T", str(T), "--qp_iter", "2", "--deq_out_type",
            str(out_type), "--layer_type", "conv", *extra]


def _policies(argv, seed=0):
    """The JAX policy, its flax init (seed), and the port's with those
    weights (float64)."""
    from diff_qp_mpc_tpu.envs import make_env as jax_env
    from diff_qp_mpc_tpu.learning.train import build_parser as jax_parser
    from diff_qp_mpc_tpu.learning.train import make_policy as jax_make
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy

    jpol = jax_make(jax_parser().parse_args(argv), jax_env("pendulum"))
    params = jpol.init(jax.random.PRNGKey(seed), jnp.zeros((2, 2)),
                       qp_solve=False)
    pol = make_policy(build_parser().parse_args(argv), make_env("pendulum"))
    return jpol, params, load_flax(pol, params, torch.float64)


X = np.random.RandomState(1).uniform([-np.pi, -1.0], [np.pi, 1.0], (6, 2))


@functools.lru_cache(maxsize=None)
def _jax_conv_policy(out_type):
    """The flax conv DEQ-MPC policy's float64 iterates and dynamics
    residual from X, and its parameters."""
    jpol, params, _ = _policies(_argv(out_type))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    jits, jres = jax.jit(lambda p, x: jpol.apply(p, x, qp_solve=True))(
        params, X)
    return params, jits, float(jres)


@pytest.mark.parametrize("out_type,dt", [(1, "f64"), (2, "f64"),
                                         (2, "f32")])
def test_conv_deqmpc_policy_matches_flax(out_type, dt):
    """The conv DEQ-MPC policy on the AL scan path: every iterate's
    proposal, states and actions, and the dynamics residual."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy

    dtype = DTYPES[dt][0]
    params, jits, jres = _jax_conv_policy(out_type)
    pol = load_flax(make_policy(build_parser().parse_args(_argv(out_type)),
                            make_env("pendulum")), params, dtype)
    assert pol.layer.layer_type == "conv"
    with torch.no_grad():
        its, res = pol(torch.tensor(X, dtype=dtype))
    tol = SOLVE_TOL[dt]
    for k, (a, b) in enumerate(zip(its, jits)):
        for name in ("net_states", "states", "actions"):
            err = rel_err(getattr(a, name), getattr(b, name))
            assert err <= tol, (k, name, err)
    assert abs(float(res) - jres) <= tol * max(1.0, abs(jres))


@pytest.mark.parametrize("out_type", [0, 3, 4])
@pytest.mark.parametrize("layer_type", ["mlp", "conv"])
def test_deqmpc_policy_refuses_out_types_jax_fails_on(out_type, layer_type):
    """The port raises a ValueError naming the out_type at construction;
    the JAX policy fails on the same flags when it first runs."""
    from diff_qp_mpc_tpu.envs import make_env as jax_env
    from diff_qp_mpc_tpu.learning.train import build_parser as jax_parser
    from diff_qp_mpc_tpu.learning.train import make_policy as jax_make
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy

    argv = [a if a != "conv" else layer_type for a in _argv(out_type)]
    with pytest.raises(ValueError, match=f"out_type {out_type}"):
        make_policy(build_parser().parse_args(argv), make_env("pendulum"))
    jpol = jax_make(jax_parser().parse_args(argv), jax_env("pendulum"))
    with pytest.raises(Exception):
        jpol.init(jax.random.PRNGKey(0), jnp.zeros((2, 2)), qp_solve=False)


def test_conv_train_step_matches_jax():
    """One clip + Adam training step with --layer_type conv (pendulum, AL
    scan path, deq_iter 2, hdim 16, B 4, float64): loss, gradient norm and
    every updated parameter against the JAX trainer's jitted step."""
    import optax

    from diff_qp_mpc_tpu.learning import train as jax_train
    from diff_qp_mpc_tpu_torch.learning import train

    argv = _argv(2, ["--qp_solve", "--policy_out_type", "2", "--bsz", "4",
                     "--grad_clip", "0.5"])
    jargs = jax_train.build_parser().parse_args(argv)
    jpol, params, pol = _policies(argv, seed=2)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    opt = optax.chain(optax.clip_by_global_norm(jargs.grad_clip),
                      optax.adam(jargs.lr))
    rng = np.random.RandomState(3)
    batch = {"state": rng.uniform(-1, 1, (4, T, 2)),
             "action": rng.uniform(-1, 1, (4, T, 1)),
             "mask": np.ones((4, T))}
    jparams, _, jl, jle, jdr, jn = jax_train.make_train_step(
        jpol, opt, jargs)(params, opt.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0), qp_solve=True)
    args = train.build_parser().parse_args(argv + ["--device", "cpu"])
    adam = train.Adam(dict(pol.named_parameters()), args.lr)
    step = train.make_train_step(pol, adam, args, torch.Generator())
    tl, tle, tdr, tn = step({k: torch.tensor(v) for k, v in batch.items()},
                            True)
    for got, ref in ((tl, jl), (tle, jle), (tdr, jdr), (tn, jn)):
        assert rel_err(got, ref) <= 1e-6, (float(got), float(ref))
    assert float(tn) > jargs.grad_clip  # the clip acts
    ref = params_from_flax(_np_tree(jparams)["params"], pol.flax_modules())
    for name, v in pol.state_dict().items():
        assert rel_err(v, ref[name]) <= 1e-6, name


# ---------------------------------------------------- checkpoint trees ----
@pytest.mark.parametrize("net", ["conv_policy", "deq_policy"])
def test_msgpack_round_trip_through_jax(net, tmp_path):
    """The port's checkpoint of each new tree: byte-identical to flax's
    serialization of the same tree, and read back by the JAX package's
    load_checkpoint with the JAX template, leaf for leaf."""
    import flax.serialization

    from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint
    from diff_qp_mpc_tpu_torch.utils.checkpoint import save_checkpoint

    if net == "conv_policy":
        jpol, params, pol = _policies(_argv(2))
        template = jax.eval_shape(lambda: jpol.init(
            jax.random.PRNGKey(9), jnp.zeros((2, 2)), qp_solve=False))
    else:
        jpol = jdeq.DEQPolicy(nx=2, T=4, hdim=16)
        params = jpol.init(jax.random.PRNGKey(4), jnp.zeros((3, 2)))
        pol = load_flax(deq.DEQPolicy(nx=2, T=4, hdim=16), params,
                        torch.float32)
        template = jax.eval_shape(lambda: jpol.init(jax.random.PRNGKey(9),
                                                    jnp.zeros((3, 2))))
    pol = pol.float()
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, pol.state_dict(), modules=pol.flax_modules())
    want = flax.serialization.to_bytes(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                params)})
    assert open(path, "rb").read() == want
    assert dumps({"params": {"params": params_to_flax(
        pol.state_dict(), pol.flax_modules())}}) == want
    restored = load_checkpoint(path, {"params": template})["params"]
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(b, np.float32))


# --------------------------------------------- the reference's checkpoint --
def test_reference_torch_policy_adapter_matches_jax(tmp_path):
    """load_reference_torch_policy on a state dict with the reference's
    key names (written here: the reference's own file is not in the repo)
    gives the port exactly the JAX adapter's weights, lndeq2 as the inner
    LayerNorm and lndeq3 as the outer, and the same forward."""
    from diff_qp_mpc_tpu.learning.data import (
        load_reference_torch_policy as jax_adapter,
    )
    from diff_qp_mpc_tpu_torch.learning.data import (
        load_reference_torch_policy,
    )

    rng = np.random.RandomState(7)
    hdim, nx, Tr = 16, 2, 5
    shapes = {"model.inp_layer.0": (hdim, nx * Tr),
              "model.inp_layer.1": (hdim,), "model.fcdeq1": (hdim, hdim),
              "model.lndeq1": (hdim,), "model.fcdeq2": (hdim, hdim),
              "model.lndeq2": (hdim,), "model.lndeq3": (hdim,),
              "model.out_layer.0": (nx * (Tr - 1), hdim)}
    sd = {}
    for key, shape in shapes.items():
        sd[f"{key}.weight"] = torch.tensor(rng.randn(*shape),
                                           dtype=torch.float32)
        sd[f"{key}.bias"] = torch.tensor(rng.randn(shape[0]),
                                         dtype=torch.float32)
    sd["model.extra_buffer"] = torch.zeros(1)  # keys outside the policy
    path = tmp_path / "bc_sac_pen"
    buf = io.BytesIO()
    torch.save(sd, buf)
    path.write_bytes(buf.getvalue())

    got = load_reference_torch_policy(str(path))
    want = params_from_flax(_np_tree(jax_adapter(str(path)))["params"])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["layer.cell.ln_inner.weight"],
                       sd["model.lndeq2.weight"])
    assert torch.equal(got["layer.cell.ln_out.weight"],
                       sd["model.lndeq3.weight"])
    # the port's out_type 1 policy takes them
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy

    pol = make_policy(build_parser().parse_args(
        ["--env", "pendulum", "--deq", "--hdim", str(hdim), "--T", str(Tr),
         "--deq_out_type", "1"]), make_env("pendulum"))
    pol.load_state_dict(got)
