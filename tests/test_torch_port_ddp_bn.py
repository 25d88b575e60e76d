"""Sync BN over 4 gloo ranks against the JAX ABN on the whole batch.

Each rank normalises its 2 rows of an (8, 6, 9, 9) batch with the whole
batch's statistics: the unfused ABN, the fused ABN (its kernels' plain
versions on the CPU) and the discriminator's BatchNorm2d, in train mode,
with a process group. Against the JAX `ABN` applied to all 8 rows: the
output and dx (the ranks' rows in order), the parameter gradients summed
over the ranks (as the train step sums them), and the running statistics
(the Bessel factor of the global count). Against the JAX `axis_name` ABN
under `shard_map` over 4 devices (the construction of
tests/test_ops.py::test_sync_bn_matches_global_batch): the output and the
running statistics, at its tolerances. Tolerances: outputs and statistics
rtol 1e-5 (atol 1e-6), gradients 1e-5 of their largest entry: both sides do
the same f32 operations with the sums in another order; 1e-4 against
`shard_map`, the tolerance there.

The WGAN-GP's double backward through the synced BatchNorm2d: the gradient
of a gradient penalty, on an (8, 3, 2, 2) batch (32 values a channel, so
the batch means weigh a few percent), against `jax.grad` of the same
penalty over the whole batch. The collectives of the BN backward are
differentiable; made non-differentiable, this case fails (its cross-rank
terms vanish), while the step's (tests/test_torch_port_ddp_step.py) D
update moves by only 0.06–0.12 %, below its tolerance.
"""

import numpy as np
import pytest

import ddp_cases

N, C, H, W = 8, 6, 9, 9
JAX_ACT = {"abn": "leaky_relu", "abn_fused": "leaky_relu", "batchnorm2d": "none"}


def _inputs():
    rng = np.random.RandomState(5)
    x = (rng.randn(N, C, H, W) * 2.0 + 1.0).astype(np.float32)
    dz = rng.randn(N, C, H, W).astype(np.float32)
    weight = (rng.randn(C) + 0.2).astype(np.float32)  # signed: |w| + eps for ABN
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    return x, dz, weight, bias


@pytest.fixture(scope="module")
def ranks():
    from structure_knowledge_distillation_tpu_torch.parallel import launch

    return launch(ddp_cases.rank_bn, ddp_cases.WORLD, *_inputs(), timeout=300)


def _jax_module(kind, axis_name=None):
    from structure_knowledge_distillation_tpu.ops import batch_norm as jbn

    if kind == "batchnorm2d":
        return jbn.BatchNorm2d(axis_name=axis_name)
    return jbn.ABN(activation=JAX_ACT[kind], axis_name=axis_name)


def _jax_whole_batch(kind):
    """(z, dx, dweight, dbias, running_mean, running_var) of the JAX module
    on the whole batch, NCHW."""
    import jax
    import jax.numpy as jnp

    x, dz, weight, bias = _inputs()
    mod = _jax_module(kind)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = mod.init(jax.random.PRNGKey(0), xh, use_running_average=False)
    params = {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)}

    def f(xh, params):
        return mod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xh,
                         use_running_average=False, mutable=["batch_stats"])

    z, stats = f(xh, params)
    _, pull = jax.vjp(lambda a, p: f(a, p)[0], xh, params)
    dxh, dparams = pull(jnp.asarray(dz.transpose(0, 2, 3, 1)))
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return (to_nchw(z), to_nchw(dxh), np.asarray(dparams["weight"]),
            np.asarray(dparams["bias"]), np.asarray(stats["batch_stats"]["mean"]),
            np.asarray(stats["batch_stats"]["var"]))


def _rows(ranks, kind, key):
    return np.concatenate([r[kind][key] for r in ranks])


@pytest.mark.parametrize("kind", list(ddp_cases.BN_KINDS))
def test_sync_bn_equals_the_jax_whole_batch(ranks, kind):
    z, dx, dw, db, mean, var = _jax_whole_batch(kind)
    np.testing.assert_allclose(_rows(ranks, kind, "z"), z, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_rows(ranks, kind, "dx"), dx, rtol=0,
                               atol=1e-5 * np.abs(dx).max())
    for got, want in ((ranks[0][kind]["dweight"], dw), (ranks[0][kind]["dbias"], db)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(ranks[0][kind]["running_mean"], mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0][kind]["running_var"], var, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", list(ddp_cases.BN_KINDS))
def test_sync_bn_equals_the_jax_shard_map(ranks, kind):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    x, _, weight, bias = _inputs()
    mesh = Mesh(np.array(jax.devices()[:ddp_cases.WORLD]), ("data",))
    sync = _jax_module(kind, axis_name="data")
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = _jax_module(kind).init(jax.random.PRNGKey(0), xh, use_running_average=False)
    variables = {"params": {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}

    def per_shard(xs):
        y, st = sync.apply(variables, xs, use_running_average=False, mutable=["batch_stats"])
        return y, st["batch_stats"]["mean"], st["batch_stats"]["var"]

    y, mean, var = shard_map(per_shard, mesh=mesh, in_specs=P("data"),
                             out_specs=(P("data"), P(), P()), check_vma=False)(xh)
    np.testing.assert_allclose(_rows(ranks, kind, "z"),
                               np.asarray(y).transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ranks[0][kind]["running_mean"], np.asarray(mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ranks[0][kind]["running_var"], np.asarray(var),
                               rtol=1e-3, atol=1e-5)


def test_ranks_agree_bit_for_bit(ranks):
    for kind in ddp_cases.BN_KINDS:
        for key in ("dweight", "dbias", "running_mean", "running_var"):
            for r in ranks[1:]:
                assert np.array_equal(r[kind][key], ranks[0][kind][key]), (kind, key)


def test_helpers(ranks):
    world = ddp_cases.WORLD
    want = np.repeat(np.arange(world, dtype=np.float32), 2)[:, None].repeat(3, 1)
    for rank, r in enumerate(ranks):
        h = r["helpers"]
        np.testing.assert_array_equal(h["gathered"], want)
        np.testing.assert_array_equal(h["broadcast"][0], np.ones(4, np.float32))
        np.testing.assert_array_equal(h["broadcast"][1], np.arange(3))
        np.testing.assert_array_equal(h["shard"], np.arange(2 * rank, 2 * rank + 2))


def test_double_backward_equals_jax(ranks):
    import jax
    import jax.numpy as jnp

    from structure_knowledge_distillation_tpu.ops import batch_norm as jbn

    x, w_out, weight, bias = ddp_cases.gp_inputs()
    mod = jbn.BatchNorm2d()
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    stats = mod.init(jax.random.PRNGKey(0), xh, use_running_average=False)["batch_stats"]

    def f(xh, p):
        z, _ = mod.apply({"params": {"weight": p["weight"], "bias": p["bias"]},
                          "batch_stats": stats}, xh, use_running_average=False,
                         mutable=["batch_stats"])
        return jnp.sum(p["w_out"] * jax.nn.leaky_relu(z, 0.2))

    def gp(xh, p):
        g = jax.grad(f)(xh, p)
        return jnp.mean((jnp.sqrt(jnp.sum(g.reshape(g.shape[0], -1) ** 2, axis=1)) - 1.0) ** 2)

    p = {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias),
         "w_out": jnp.asarray(w_out.transpose(1, 2, 0))}
    dxh, dp = jax.grad(gp, argnums=(0, 1))(xh, p)
    want = {"dx": np.asarray(dxh).transpose(0, 3, 1, 2), "dweight": np.asarray(dp["weight"]),
            "dbias": np.asarray(dp["bias"]),
            "dw_out": np.asarray(dp["w_out"]).transpose(2, 0, 1)}
    got = {k: np.concatenate([r["gp"][k] for r in ranks]) if k == "dx" else ranks[0]["gp"][k]
           for k in want}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)
