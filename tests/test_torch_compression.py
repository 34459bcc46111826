"""The port's gradient compression (``repro_torch.train.compression``)
against the reference's: ``quantize_int8`` / ``dequantize_int8`` bit for
bit (``torch.round`` rounds half to even, as ``jnp.round`` does), the
error bound, the tree <-> vector round trip with bf16, and the compressed
data-parallel step over ``["cpu"] * 4`` against the reference's
``shard_map`` step on a 4-device mesh (a subprocess under
``--xla_force_host_platform_device_count=4``, its step jitted whole).

The DP step's bar is 1e-5 on losses, params and residuals. The two
packages' gradients agree to a few float32 ulps, and an int8 value that
sits on a rounding boundary could round the other way (one step of the
block's scale, up to max|g|/127, in that shard's residual); on these
inputs no value does: the measured differences over the 5 steps are
9.5e-7 on the loss (one ulp of 13.4), 6.0e-8 on the params and 5.8e-7
on the residuals.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.compression import dequantize_int8 as j_dequantize
from repro.train.compression import quantize_int8 as j_quantize
from repro_torch.train.compression import (dequantize_int8,
                                           make_compressed_dp_step,
                                           quantize_int8, tree_to_vec,
                                           vec_to_tree)

ROOT = Path(__file__).resolve().parents[1]


def _values(n, seed):
    g = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    # one block of exact halves: max 127 -> scale 1, so x.5 rounds to even
    if n >= 2048:
        g[:2048] = np.resize(np.arange(-127, 128, dtype=np.float32) + 0.5,
                             2048).clip(-127, 127)
        g[0] = 127.0
    return g


@pytest.mark.parametrize("n", [5000, 2048 * 3 + 1, 17])
def test_quantize_int8_bit_exact(n):
    g = _values(n, n)
    q, scale, m = quantize_int8(torch.from_numpy(g))
    jq, jscale, jm = j_quantize(jnp.asarray(g))
    assert m == jm == n
    assert q.dtype == torch.int8 and q.shape == (-(-n // 2048), 2048)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = dequantize_int8(q, scale, m)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(j_dequantize(jq, jscale, jm)))


def test_int8_quantization_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=5000)
                         .astype(np.float32))
    q, scale, n = quantize_int8(g)
    err = (dequantize_int8(q, scale, n) - g).abs().numpy()
    bound = np.repeat(scale.numpy()[:, 0] * 0.5 + 1e-9, 2048)[:5000]
    assert (err <= bound).all()


def test_tree_vec_roundtrip():
    tree = {"b": torch.arange(5.0), "a": torch.ones((3, 2), dtype=torch.bfloat16),
            "c": [torch.full((2,), 2.5)]}
    vec, meta = tree_to_vec(tree)
    assert vec.dtype == torch.float32 and vec.shape == (13,)
    # leaves in sorted-key order, as jax.tree flattens a dict
    assert vec[:6].tolist() == [1.0] * 6 and vec[6:11].tolist() == [0, 1, 2, 3, 4]
    back = vec_to_tree(vec, meta)
    assert list(back) == ["b", "a", "c"]
    for k in ("a", "b"):
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k])
    assert torch.equal(back["c"][0], tree["c"][0])


def _problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    return X, (X @ w_true).astype(np.float32)


def _loss(params, batch):
    x, y = batch
    return ((x @ params["w"] - y) ** 2).mean()


_REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.train.compression import make_compressed_dp_step
    assert jax.device_count() == 4
    mesh = jax.make_mesh((4,), ('data',))
    d = np.load(sys.argv[1])
    X, Y = jnp.asarray(d['X']), jnp.asarray(d['Y'])
    def loss_fn(params, batch):
        x, y = batch
        return jnp.mean((x @ params['w'] - y) ** 2)
    step = make_compressed_dp_step(loss_fn, mesh, 'data', lr=0.1)
    params = {'w': jnp.zeros(8)}
    state = (params, step.init_residual(params))
    jstep = jax.jit(step)
    out = {'loss': [], 'w': [], 'res': []}
    for i in range(5):
        state, loss = jstep(state, (X, Y))
        out['loss'].append(float(loss))
        out['w'].append(np.asarray(state[0]['w']).tolist())
        out['res'].append(np.asarray(state[1]).tolist())
    print(json.dumps(out))
""")


def test_compressed_dp_step_matches_reference_mesh(tmp_path):
    X, Y = _problem()
    np.savez(tmp_path / "data.npz", X=X, Y=Y)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE,
                           str(tmp_path / "data.npz")], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])

    step = make_compressed_dp_step(_loss, ["cpu"] * 4, lr=0.1)
    params = {"w": torch.zeros(8)}
    state = (params, step.init_residual(params))
    assert state[1].shape == (4, 8)
    batch = (torch.from_numpy(X), torch.from_numpy(Y))
    for i in range(5):
        state, loss = step(state, batch)
        assert abs(float(loss) - want["loss"][i]) <= 1e-5 * max(
            1.0, abs(want["loss"][i]))
        np.testing.assert_allclose(state[0]["w"].numpy(), want["w"][i],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(state[1].numpy(), want["res"][i],
                                   rtol=0, atol=1e-5)
    assert want["loss"][-1] < want["loss"][0]


def test_compressed_dp_convergence():
    """The reference test's problem, 200 steps over ["cpu"] * 4."""
    X, Y = _problem()
    step = make_compressed_dp_step(_loss, ["cpu"] * 4, lr=0.1)
    params = {"w": torch.zeros(8)}
    state = (params, step.init_residual(params))
    batch = (torch.from_numpy(X), torch.from_numpy(Y))
    for _ in range(200):
        state, loss = step(state, batch)
    assert float(loss) < 1e-3, float(loss)


def test_compressed_dp_on_two_device_stacks_equals_one():
    X, Y = _problem()
    batch = (torch.from_numpy(X), torch.from_numpy(Y))
    outs = []
    for devices in (["cpu"] * 4, ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]):
        step = make_compressed_dp_step(_loss, devices, lr=0.1)
        state = ({"w": torch.zeros(8)}, step.init_residual(
            {"w": torch.zeros(8)}))
        for _ in range(3):
            state, loss = step(state, batch)
        outs.append((state[0]["w"], state[1], loss))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_no_error_feedback_keeps_residual_out():
    X, Y = _problem()
    batch = (torch.from_numpy(X), torch.from_numpy(Y))
    res = []
    for ef in (True, False):
        step = make_compressed_dp_step(_loss, ["cpu"] * 2, lr=0.1,
                                       error_feedback=ef)
        state = ({"w": torch.zeros(8)}, step.init_residual(
            {"w": torch.zeros(8)}))
        for _ in range(2):
            state, _ = step(state, batch)
        res.append(state[0]["w"])
    assert not torch.equal(res[0], res[1])
