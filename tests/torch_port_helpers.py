"""Shared by the port's test files (tests/test_torch_port_*.py).

Every port file runs its module at a lowered CPU priority
(`lowered_priority`, in its `one_torch_thread` fixture): the suite's
longest file, the JAX package's tests/test_zoo_training.py, sets the
suite's wall clock (ROADMAP.md, "The time budget"), and a busy CPU then
serves it and the other JAX files before the port's. The priority comes
back when the module ends, so that a worker later handed a JAX file runs
it at normal priority.

The data-parallel files (test_torch_port_dist.py,
test_torch_port_dist_zoos.py) start themselves as the ranks of a gloo
group in child processes (`ranks_running`, `wait_ranks`); the children
save what they saw, and the tests hold it against one process
(`check_step`).

The determinism files (test_torch_port_determinism*.py) record the ATen
ops of a training step (`OpRecorder`) and hold them against the ops torch
has no deterministic CUDA form for (`NO_DETERMINISTIC_CUDA`).
"""

import contextlib
import hashlib
import importlib.util
import numpy as np
import os
import subprocess
import sys

from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


def _set_thread_priority(tid: int, nice: int) -> None:
    # a thread may have ended since it was listed; raising a priority back
    # needs root
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.setpriority(os.PRIO_PROCESS, tid, nice)


def _thread_ids() -> list:
    return [int(t) for t in os.listdir("/proc/self/task")]


def _thread_priorities() -> dict:
    """{thread id: nice} of this process's threads. A thread listed in
    /proc/self/task may end before its priority is read (a worker's pools
    start and end threads of their own at any time): it is left out."""
    out = {}
    for tid in _thread_ids():
        with contextlib.suppress(ProcessLookupError):
            out[tid] = os.getpriority(os.PRIO_PROCESS, tid)
    return out


@contextlib.contextmanager
def lowered_priority(increment: int = 19):
    """Every thread of this process at +increment inside the block (threads
    and children started there inherit it), every thread at the process's
    old priority after it, so that a test worker later handed another file
    runs that at normal priority.

    Each thread is set by its id: on Linux os.nice changes the calling
    thread only, and a worker that ran a JAX file first already holds
    XLA's thread pool, which would otherwise compute the port file's JAX
    references at normal priority (and a pool that the block created would
    stay lowered after it)."""
    old = _thread_priorities()
    normal = os.getpriority(os.PRIO_PROCESS, 0)
    for tid, nice in old.items():
        _set_thread_priority(tid, min(nice + increment, 19))
    try:
        yield
    finally:
        for tid in _thread_ids():
            _set_thread_priority(tid, old.get(tid, normal))


@contextlib.contextmanager
def ranks_running(script: str, world: int, tmp: str):
    """`python script RANK TMP` for each rank, in `tmp`, one torch thread
    each, PYTHONPATH the repository only, output captured; yields the
    processes and kills any still running when the block ends."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), str(r), tmp], env=env,
                              cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        yield procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def wait_ranks(procs, timeout: float = CHILD_TIMEOUT_S) -> list:
    """Wait for the children (a hung collective fails after `timeout` s);
    assert each exited 0; return their logs."""
    logs = [p.communicate(timeout=timeout)[0].decode(errors="replace") for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return logs


def jax_tool(name: str):
    """The JAX package's tools/<name>.py as a fresh module (tools/ is not a
    package; a fresh module also starts with fresh module state)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(arrays: dict) -> dict:
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def split(arrays: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix)}


def named(state, what: str) -> dict:
    """The gradients ("grads"), parameters ("params") or BN running
    statistics ("buffers") of a TrainState's two networks, as numpy arrays
    named depth.* / pose.*."""
    out = {}
    for net, m in (("depth", state.depth_net), ("pose", state.pose_net)):
        if what == "grads":
            out.update({f"{net}.{n}": p.grad.detach().clone().numpy()
                        for n, p in m.named_parameters() if p.grad is not None})
        elif what == "params":
            out.update({f"{net}.{n}": p.detach().clone().numpy()
                        for n, p in m.named_parameters()})
        else:
            out.update({f"{net}.{n}": b.detach().clone().numpy()
                        for n, b in m.named_buffers() if "running_" in n})
    return out


def check_step(got, ref, k, what, loss_rtol, grad_rtol, grad_atol, leaf_rtol, leaf_rms,
               stats_rtol, stats_floor, pinned_at, depth_stats_floor=None, deep_rtol=None):
    """Step k of a multi-process run against a reference step from the same
    state: the loss; each gradient per entry (rtol + atol) and as a tensor
    (L2 of the difference within leaf_rtol of the reference's + leaf_rms
    RMS); BN statistics to stats_rtol + stats_floor of the tensor's largest
    entry; parameters where both gradients exceed pinned_at (Adam's update
    of an entry whose gradient is near 0 follows the sign of noise) to 1e-6
    after the first step, whose update is lr * g / (|g| + eps), and to 1e-5
    after the second, whose update divides a sum of two steps' moments in
    which the gradients can cancel, magnifying a gradient's difference.
    With `depth_stats_floor` the depth network's BN statistics take that
    floor; with `deep_rtol` (a ResNet-50 depth network, ROADMAP.md, C) its
    gradients take deep_rtol as the tensor bound and deep_rtol of the
    tensor's largest entry on top of the per-entry bound, and its
    parameters are held where both gradients exceed pinned_at plus that
    allowance. Returns the measured maxima."""
    loss = got["loss"]
    np.testing.assert_allclose(loss, ref["loss"], rtol=loss_rtol, err_msg=f"{what} loss {k}")
    g = got["grads"]
    # a head outside the step's scales has no gradient in the port, zeros in JAX
    assert all(not v.any() for n, v in ref["grads"].items() if n not in g)
    worst = {"loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]), "entry": 0.0, "leaf": 0.0,
             "stats": 0.0, "param": 0.0}
    for n, gv in g.items():
        r = ref["grads"][n].astype(np.float64)
        is_deep = deep_rtol is not None and n.startswith("depth.")
        d = np.abs(gv.astype(np.float64) - r)
        excess = float((d - grad_rtol * np.abs(r)).max())
        atol = grad_atol + (deep_rtol * float(np.abs(r).max()) if is_deep else 0.0)
        assert excess <= atol, f"{what} step {k} grad {n}: {excess:.3e}"
        err, norm = np.linalg.norm(d), np.linalg.norm(r)
        rtol = deep_rtol if is_deep else leaf_rtol
        assert err <= rtol * norm + leaf_rms * np.sqrt(r.size), \
            f"{what} step {k} grad {n}: |diff| {err:.3e}, |g| {norm:.3e}"
        worst["entry"] = max(worst["entry"], excess)
        if norm > 1e-5:
            worst["leaf"] = max(worst["leaf"], err / norm)
        # a ResNet-50 tensor's entries may differ by its allowance: pinned
        # beyond it, where the two gradients' signs agree
        pinned_beyond = pinned_at + (atol - grad_atol)
        pinned = (np.abs(r) > pinned_beyond) & (np.abs(gv) > pinned_beyond)
        dp = np.abs(got["params"][n] - ref["params"][n])[pinned]
        if dp.size:
            assert dp.max() <= (1e-6, 1e-5)[k], f"{what} step {k} param {n}: {dp.max():.3e}"
            worst["param"] = max(worst["param"], float(dp.max()))
    for n, v in got["buffers"].items():
        r = ref["buffers"][n]
        floor = stats_floor
        if depth_stats_floor is not None and n.startswith("depth."):
            floor = depth_stats_floor
        np.testing.assert_allclose(v, r, rtol=stats_rtol, atol=floor * np.abs(r).max(),
                                   err_msg=f"{what} step {k} {n}")
        worst["stats"] = max(worst["stats"], float(np.abs(v - r).max() / np.abs(r).max()))
    return worst


# The ops that torch.use_deterministic_algorithms documents as having no
# deterministic CUDA implementation (it raises on them), as of torch
# 2.13.0's docstring, by ATen name, each with the case that raises (None:
# every call); plus replication_pad*d_backward, which that docstring counts
# as deterministic but whose CUDA kernels add with atomics in older
# releases (the card's machine runs torch 2.11.0) and which the step
# reached until ops/pad.py folded the length-1 pad itself.
def _arg(func, args, kwargs, name):
    names = [a.name for a in func._schema.arguments]
    i = names.index(name)
    return args[i] if i < len(args) else kwargs.get(name)


NO_DETERMINISTIC_CUDA = {
    **dict.fromkeys((
        "avg_pool3d_backward", "_adaptive_avg_pool2d_backward", "_adaptive_avg_pool3d_backward",
        "adaptive_max_pool2d_backward", "fractional_max_pool2d_backward",
        "fractional_max_pool3d_backward", "max_unpool2d", "max_unpool3d",
        "upsample_linear1d_backward", "upsample_bilinear2d_backward",
        "_upsample_bilinear2d_aa_backward", "upsample_bicubic2d_backward",
        "_upsample_bicubic2d_aa_backward", "upsample_trilinear3d_backward",
        "reflection_pad1d_backward", "reflection_pad2d_backward", "reflection_pad3d_backward",
        "replication_pad1d_backward", "replication_pad2d_backward",
        "replication_pad3d_backward", "nll_loss_forward", "nll_loss2d_forward",
        "_ctc_loss_backward", "put", "put_", "histc", "grid_sampler_2d_backward",
        "grid_sampler_3d_backward")),
    "_embedding_bag_backward": lambda f, a, k: _arg(f, a, k, "mode") == 2,  # max
    "bincount": lambda f, a, k: _arg(f, a, k, "weights") is not None,
    "median": lambda f, a, k: "dim" in [x.name for x in f._schema.arguments],
    "nanmedian": lambda f, a, k: "dim" in [x.name for x in f._schema.arguments],
    "cumsum": lambda f, a, k: a[0].is_floating_point() or a[0].is_complex(),
    "cumsum_": lambda f, a, k: a[0].is_floating_point() or a[0].is_complex(),
    "scatter_reduce": lambda f, a, k: _arg(f, a, k, "reduce") == "prod",
}


class OpRecorder(TorchDispatchMode):
    """Records every ATen op dispatched inside the block (forward, and the
    backward that autograd runs in the same process), by name, and which of
    them NO_DETERMINISTIC_CUDA refuses (`refused`)."""

    def __init__(self):
        super().__init__()
        self.ops = set()
        self.refused = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops.add(name)
        if name in NO_DETERMINISTIC_CUDA:
            case = NO_DETERMINISTIC_CUDA[name]
            if case is None or case(func, args, kwargs):
                self.refused.add(name)
        return func(*args, **kwargs)
