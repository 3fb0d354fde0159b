"""Port parity: camera geometry of baseboostdepth_tpu_torch against
baseboostdepth_tpu, values and gradients, fp32. Tolerance 1e-6 relative
(float32 sums taken in another order), with an absolute floor of 1e-6 times
the array's largest magnitude for entries that cancel to near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu import geometry as jg
from baseboostdepth_tpu_torch import geometry as tg
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


RTOL = 1e-6


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale)


def _poses(seed, shape):
    rng = np.random.default_rng(seed)
    aa = (rng.standard_normal(shape + (3,)) * 0.05).astype(np.float32)
    t = (rng.standard_normal(shape + (3,)) * 0.3).astype(np.float32)
    return aa, t


def _kitti(B, H, W):
    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1.0
    return K, np.linalg.inv(K).astype(np.float32)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(invert):
    aa, t = _poses(0, (4, 3))
    ct = np.random.default_rng(1).standard_normal((4, 3, 4, 4)).astype(np.float32)

    def jf(a, b):
        return jnp.sum(jg.transformation_from_parameters(a, b, invert=invert) * ct)

    jT = jg.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t), invert=invert)
    jga, jgt = jax.grad(jf, argnums=(0, 1))(jnp.asarray(aa), jnp.asarray(t))

    ta = torch.tensor(aa, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    tT = tg.transformation_from_parameters(ta, tt, invert=invert)
    (tT * torch.from_numpy(ct)).sum().backward()
    _close(jT, tT.detach().numpy())
    _close(jga, ta.grad.numpy())
    _close(jgt, tt.grad.numpy())


def test_zero_angle_values():
    """The +1e-7 guard path at angle 0 (values only: JAX's norm gradient at
    exactly 0 is NaN, torch's is 0)."""
    aa, t = _poses(7, (2,))
    aa[0] = 0.0
    jT = jg.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t))
    tT = tg.transformation_from_parameters(torch.from_numpy(aa), torch.from_numpy(t))
    _close(jT, tT.numpy())


def test_compose_poses_and_grads():
    aa, t = _poses(2, (3, 5))
    ct = np.random.default_rng(3).standard_normal((3, 5, 4, 4)).astype(np.float32)

    def jf(a, b):
        return jnp.sum(jg.compose_poses(jg.transformation_from_parameters(a, b)) * ct)

    jout = jg.compose_poses(jg.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t)))
    jga, jgt = jax.grad(jf, argnums=(0, 1))(jnp.asarray(aa), jnp.asarray(t))

    ta = torch.tensor(aa, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    tout = tg.compose_poses(tg.transformation_from_parameters(ta, tt))
    (tout * torch.from_numpy(ct)).sum().backward()
    _close(jout, tout.detach().numpy())
    _close(jga, ta.grad.numpy())
    _close(jgt, tt.grad.numpy())


def test_warp_grid_values_and_grads():
    B, H, W = 3, 12, 20
    rng = np.random.default_rng(4)
    depth = (rng.random((B, H, W)) * 20 + 0.5).astype(np.float32)
    aa, t = _poses(5, (B,))
    K, iK = _kitti(B, H, W)
    ct = rng.standard_normal((B, H, W, 2)).astype(np.float32)

    def jf(d, a, b):
        T = jg.transformation_from_parameters(a, b, invert=True)
        return jnp.sum(jg.warp_grid(d, jnp.asarray(K), jnp.asarray(iK), T) * ct)

    T = jg.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t), invert=True)
    jgrid = jg.warp_grid(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(iK), T)
    jgd, jga, jgt = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(depth), jnp.asarray(aa), jnp.asarray(t))

    td = torch.tensor(depth, requires_grad=True)
    ta = torch.tensor(aa, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    tT = tg.transformation_from_parameters(ta, tt, invert=True)
    tgrid = tg.warp_grid(td, torch.from_numpy(K), torch.from_numpy(iK), tT)
    (tgrid * torch.from_numpy(ct)).sum().backward()
    _close(jgrid, tgrid.detach().numpy())
    _close(jgd, td.grad.numpy())
    _close(jga, ta.grad.numpy())
    _close(jgt, tt.grad.numpy())


def test_disp_to_depth_and_rays():
    disp = np.random.default_rng(6).random((2, 5, 7)).astype(np.float32)
    js, jd = jg.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)
    ts, td = tg.disp_to_depth(torch.from_numpy(disp), 0.1, 100.0)
    _close(js, ts.numpy())
    _close(jd, td.numpy())
    np.testing.assert_array_equal(np.asarray(jg.pixel_rays(5, 7)), tg.pixel_rays(5, 7).numpy())
