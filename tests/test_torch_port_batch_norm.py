"""Train-mode BatchNorm of the port (`models/resnet.py::BatchNorm2d`,
`ops/batch_norm.py`) against flax's `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`, the BatchNorm of every network of the JAX package.

flax takes the fast variance, E[x^2] - E[x]^2 of float32 sums (float64 for
a float64 input), and applies y = (x - mean) * (rsqrt(var + eps) * scale) +
bias. Torch's own BatchNorm takes the two-pass variance E[(x - E[x])^2].
The two differ most where a channel's mean is large against its spread,
but there two fast-variance implementations also differ by their order of
summation as much as the formulas differ. So the input here has B*H*W = 16
(1x4x4) and integer channels around 600-1000 with a spread of +-3, plus
one ordinary normal channel: every partial sum is an exact float32 integer
below 2^24, so E[x] and E[x^2] are the same in any order, and the fast
variance is one function of x whoever computes it (its mean^2 rounds where
the two-pass variance does not).

Held, after one train-mode call from fresh running statistics (measured
on this input, seed 0, in brackets: float32 / float64 / bf16):
  - running mean and var to 1e-6 relative [1.1e-7 and 8.6e-8 / 4.0e-16
    and 2.3e-8, as flax keeps its running statistics in float32 / equal];
  - the output to 1e-5 of its largest entry, a bf16 output to one bf16
    rounding of it [1.7e-7 / 3.1e-16 / equal];
  - the gradients of the input, weight and bias (of sum(y * cotangent)) to
    1e-5 of their largest entry [input 5.6e-6 / 5.2e-15 / equal: E[x^2] -
    E[x]^2 cancels to about 1/300 of its terms in these channels, so both
    autodiffs' float32 roundings of the large terms show; weight and bias
    up to 2.1e-7 / 2.0e-16 / 1.1e-7];
  - the same statistics from `torch.var_mean` (the two-pass variance the
    port used in one process before) miss the 1e-6 bound: its running var
    differs by 2.8e-4 to 1.3e-3 relative in 5 of 8 channels.
The bf16 case runs the float32 module on a bf16 input under CPU autocast
against flax's dtype=bf16 BatchNorm, on bf16-exact integers (multiples of
4). Time: ~15 s on one worker (the JAX import included).
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import lowered_priority

C = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def exact_sum_input(seed=0, step=1):
    """x [1, C, 4, 4]: C - 1 integer channels of mean 600-1000 and spread
    +-3 * step (step 4 keeps them bf16-exact), and one normal channel; the
    weight, bias and a cotangent."""
    rng = np.random.default_rng(seed)
    x = np.empty((1, C, 4, 4), np.float64)
    base = rng.integers(600 // step, 1000 // step, C - 1) * step
    x[0, :C - 1] = base[:, None, None] + step * rng.integers(-3, 4, (C - 1, 4, 4))
    x[0, C - 1] = rng.standard_normal((4, 4))
    weight = rng.uniform(0.5, 1.5, C)
    bias = rng.uniform(-0.5, 0.5, C)
    ct = rng.standard_normal(x.shape)
    return x, weight, bias, ct


def port_batch_norm(x, weight, bias, ct, dtype):
    """One train-mode call of the port's BatchNorm2d: output, running
    statistics, gradients (float64 numpy)."""
    from baseboostdepth_tpu_torch.models.resnet import BatchNorm2d

    mod_dtype = torch.float64 if dtype == "float64" else torch.float32
    in_dtype = {"float64": torch.float64, "float32": torch.float32, "bf16": torch.bfloat16}[dtype]
    bn = BatchNorm2d(C).to(mod_dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(in_dtype).requires_grad_(True)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype == "bf16"):
        y = bn(xt)
    assert y.dtype == in_dtype
    (y.to(mod_dtype) * torch.from_numpy(ct).to(mod_dtype)).sum().backward()
    out = {"y": y, "mean": bn.running_mean, "var": bn.running_var, "dx": xt.grad,
           "dweight": bn.weight.grad, "dbias": bn.bias.grad}
    return {k: v.detach().double().numpy() for k, v in out.items()}


def flax_batch_norm(x, weight, bias, ct, dtype):
    """flax's nn.BatchNorm (the JAX package's _BN: momentum 0.9, epsilon
    1e-5, dtype bf16 for the bf16 case) on the NHWC input: the same
    outputs, NCHW."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(dtype == "float64"):
        fdt = jnp.float64 if dtype == "float64" else jnp.float32
        in_dt = {"float64": jnp.float64, "float32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
        m = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                         dtype=jnp.bfloat16 if dtype == "bf16" else None, param_dtype=fdt)
        xj = jnp.asarray(x.transpose(0, 2, 3, 1), in_dt)
        stats = m.init(jax.random.PRNGKey(0), xj)["batch_stats"]
        params = {"scale": jnp.asarray(weight, fdt), "bias": jnp.asarray(bias, fdt)}
        ctj = jnp.asarray(ct.transpose(0, 2, 3, 1), fdt)

        def loss(xx, p):
            yy, new = m.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
            return (yy.astype(fdt) * ctj).sum(), (yy, new["batch_stats"])

        (_, (y, new)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            xj, params)
        assert y.dtype == in_dt
        out = {"y": y, "mean": new["mean"], "var": new["var"], "dx": gx,
               "dweight": gp["scale"], "dbias": gp["bias"]}
        out = {k: np.asarray(v.astype(jnp.float64) if dtype == "float64" else
                             v.astype(jnp.float32)).astype(np.float64) for k, v in out.items()}
    for k in ("y", "dx"):
        out[k] = out[k].transpose(0, 3, 1, 2)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64", "bf16"])
def test_batch_norm_matches_flax(dtype):
    """Statistics to 1e-6 relative, output and gradients to 1e-5 of their
    largest entry (bf16 output: one bf16 rounding)."""
    inputs = exact_sum_input(step=4 if dtype == "bf16" else 1)
    got = port_batch_norm(*inputs, dtype)
    ref = flax_batch_norm(*inputs, dtype)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=0, err_msg=k)
    y_tol = 2.0**-8 * np.abs(ref["y"]).max() if dtype == "bf16" else 1e-5 * np.abs(ref["y"]).max()
    np.testing.assert_allclose(got["y"], ref["y"], rtol=0, atol=y_tol, err_msg="y")
    for k in ("dx", "dweight", "dbias"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5 * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_two_pass_variance_misses_the_bound():
    """The running statistics that `torch.var_mean` (two-pass variance) gives
    on the same input miss the 1e-6 bound that the port holds: the test
    input tells the two formulas apart."""
    x, weight, bias, ct = exact_sum_input()
    ref = flax_batch_norm(x, weight, bias, ct, "float32")
    var, mean = torch.var_mean(torch.from_numpy(x).float(), dim=(0, 2, 3), correction=0)
    two_pass = 0.9 + 0.1 * var.double().numpy()
    rel = np.abs(two_pass - ref["var"]) / np.abs(ref["var"])
    assert (rel > 1e-6).sum() >= 3, rel
    np.testing.assert_allclose(0.1 * mean.double().numpy(), ref["mean"], rtol=1e-6)


def test_bn_sums_plain_version_on_the_cpu():
    """bn_sums on CPU tensors is its plain version, NCHW or channels-last,
    float32 sums for bf16 and float32, float64 for float64, or float64 into
    a float64 `out` (the sums of the float32 values before their rounding);
    it refuses other dtypes, empty inputs and another `out`."""
    from baseboostdepth_tpu_torch.ops.batch_norm import bn_sums

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 4, 6, generator=g, dtype=torch.float64)
    want = torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))])
    torch.testing.assert_close(bn_sums(x), want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(bn_sums(x.to(memory_format=torch.channels_last)), want,
                               rtol=1e-12, atol=1e-12)
    for dt in (torch.float32, torch.bfloat16):
        got = bn_sums(x.to(dt))
        assert got.dtype == torch.float32
        xf = x.to(dt).double()
        torch.testing.assert_close(got.double(), torch.cat([xf.sum((0, 2, 3)),
                                                            (xf * xf).sum((0, 2, 3))]),
                                   rtol=1e-5, atol=1e-5)
        out = torch.empty(10, dtype=torch.float64)
        assert bn_sums(x.to(dt), out=out) is out
        sq = (x.to(dt).float() ** 2).double()
        torch.testing.assert_close(out, torch.cat([xf.sum((0, 2, 3)), sq.sum((0, 2, 3))]),
                                   rtol=1e-12, atol=1e-12)
        assert torch.equal(out.float(), got)
    with pytest.raises(ValueError):
        bn_sums(x.float(), out=torch.empty(10, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        bn_sums(x.half())
    with pytest.raises(ValueError):
        bn_sums(x[:0])
