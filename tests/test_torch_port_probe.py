"""The port's capability-probe tool and the plain versions of its kernels
(`ops/probe_cuda.py`) against the JAX package's `tools/pallas_probe.py`.

The JAX tool runs on the CPU with its seven Pallas kernels in interpret mode
(`pl.pallas_call` wrapped to pass interpret=True and to record each call's
inputs and output). Every probe's inputs must equal the port tool's, drawn
from the same default_rng(0) stream, and the plain versions must equal the
interpret-mode kernels and the JAX tool's numpy references exactly. The
gather rule is held against jnp.take_along_axis and the slice against
jax.lax.dynamic_slice, out-of-range cases included, exactly.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baseboostdepth_tpu_torch.ops import probe_cuda as pc
from baseboostdepth_tpu_torch.tools import pallas_probe as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("trivial", "sublane_gather", "sublane_gather_same", "lane_gather", "lane_gather_wide",
         "gather_2d_flat", "dyn_slice")


@pytest.fixture(scope="module")
def jax_tool_calls():
    """[(inputs, output)] of the JAX tool's seven pallas_calls, in order."""
    from jax.experimental import pallas as pl

    from baseboostdepth_tpu.utils import jax_setup

    spec = importlib.util.spec_from_file_location("jax_pallas_probe",
                                                  os.path.join(REPO, "tools", "pallas_probe.py"))
    module = importlib.util.module_from_spec(spec)
    calls = []
    real = pl.pallas_call

    def recording_call(*args, **kwargs):
        fn = real(*args, interpret=True, **kwargs)

        def run(*inputs):
            out = fn(*inputs)
            calls.append(([np.asarray(a) for a in inputs], np.asarray(out)))
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        mp.setattr(pl, "pallas_call", recording_call)
        mp.setattr(jax_setup, "setup_jax", lambda *a, **k: None)  # no cache dir
        spec.loader.exec_module(module)
        module.main()
    assert len(calls) == 7
    return calls


@pytest.mark.parametrize("i", range(7), ids=NAMES)
def test_probe_matches_jax_tool(jax_tool_calls, i):
    case = tool.probe_cases()[i]
    assert case.name == NAMES[i]
    jax_inputs, jax_out = jax_tool_calls[i]
    # the same arrays from the same stream (gather_2d_flat: the [1, H*W] view)
    assert len(jax_inputs) == len(case.args)
    for a, b in zip(jax_inputs, case.args):
        np.testing.assert_array_equal(a.reshape(b.shape), b)
        assert a.dtype == b.dtype
    # the plain version equals the interpret-mode Pallas kernel and the JAX
    # tool's numpy reference, exactly
    ours = tool.run_probe(case, "cpu")
    np.testing.assert_array_equal(ours, jax_out)
    np.testing.assert_array_equal(ours, case.expected)


def _jnp_take(src, idx, axis):
    return np.asarray(jnp.take_along_axis(jnp.asarray(src), jnp.asarray(idx), axis=axis))


def test_gather_rows_rule_matches_take_along_axis():
    rng = np.random.default_rng(5)
    src = rng.random((64, 128)).astype(np.float32)
    idx = rng.integers(-80, 80, (8, 128)).astype(np.int32)
    idx[0, :4] = (-64, -65, 63, 64)  # both wrap edges and both ends
    ours = pc.probe_gather_rows(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    ref = _jnp_take(src, idx, 0)
    assert np.isnan(ref).any() and (idx < 0).any()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("rows", [8, 1], ids=["rows", "broadcast_row"])
def test_gather_cols_rule_matches_take_along_axis(rows):
    rng = np.random.default_rng(6)
    n = 640 if rows == 8 else 64 * 128
    src = rng.random((rows, n)).astype(np.float32)
    idx = rng.integers(-n - 30, n + 30, (8, 128)).astype(np.int32)
    idx[1, :4] = (-n, -n - 1, n - 1, n)
    ours = pc.probe_gather_cols(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    ref = _jnp_take(np.broadcast_to(src, (8, n)), idx, 1)
    assert np.isnan(ref).any()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("start", [-1000, -65, -64, -9, -8, -1, 0, 17, 56, 57, 2**31 - 1])
def test_row_slice_matches_dynamic_slice(start):
    src = np.random.default_rng(7).random((64, 128)).astype(np.float32)
    ours = pc.probe_row_slice(torch.from_numpy(src), torch.tensor([start], dtype=torch.int32))
    ref = jax.lax.dynamic_slice(jnp.asarray(src), (jnp.int32(start), 0), (8, 128))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_wrappers_check_their_arguments():
    x = torch.zeros((8, 128))
    idx = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        pc.probe_scale(x.double())
    with pytest.raises(TypeError):
        pc.probe_gather_rows(x, idx.long())
    with pytest.raises(ValueError):
        pc.probe_gather_cols(torch.zeros((3, 128)), idx)
    with pytest.raises(ValueError):
        pc.probe_row_slice(x, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        pc.probe_gather_rows(x.t(), idx)


def test_tool_main_on_the_cpu(capsys):
    assert tool.main(device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[-2] for ln in lines] == ["OK"] * 7
    assert [ln[:34].rstrip() for ln in lines] == [c.label for c in tool.probe_cases()]


def test_tool_reports_failures(capsys, monkeypatch):
    """A probe that disagrees or raises prints FAIL and counts as failed."""
    cases = tool.probe_cases()
    cases[0].expected = cases[0].expected + 1
    cases[1].op = "missing"
    monkeypatch.setattr(tool, "probe_cases", lambda: cases)
    assert tool.main(device="cpu") == 2
    out = capsys.readouterr().out.splitlines()
    assert "FAIL" in out[0] and "FAIL AttributeError" in out[1]
    assert all(" OK " in ln for ln in out[2:])


def test_tool_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main()
