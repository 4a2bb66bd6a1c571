"""Port parity: ``lsqrrecipes_tpu_torch.synthetic`` vs ``lsqrrecipes_tpu.synthetic``.

The two packages draw from different generators, so each port generator's
build stage (``_crosswire_from_draws`` and the like) is fed the JAX
function's own draws, replayed from ``jax.random.split`` in ``synthetic.py``'s
order: the data and the truth must equal JAX's to 1e-12 (float64).  The
port's own generators must give clean data that satisfies their truth: the
port estimator's residual at the true parameters is below 1e-9.
"""

import math

import jax
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu import synthetic as jsyn
from lsqrrecipes_tpu_torch import synthetic
from lsqrrecipes_tpu_torch.estimators import us_calibration as usc

TOL = 1e-12
RESIDUAL_TOL = 1e-9
N, SIGMA = 40, 0.7


def _u(key, shape, lo, hi):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _jax_draws(kind, key, n):
    """The JAX generator's draws, in its order (``synthetic.py:33-48, 52-65,
    72-96``)."""
    if kind == "crosswire":
        k = jax.random.split(key, 6)
        return [_u(k[0], (3,), 0.0, math.pi), _u(k[1], (3,), -100, 100),
                _u(k[2], (3,), -100, 100), _u(k[3], (n, 2), 0.0, 1.0),
                _u(k[4], (n, 3), 0.0, math.pi), np.asarray(jax.random.normal(k[5], (n, 2)))]
    if kind == "pointer":
        k = jax.random.split(key, 6)
        return [_u(k[0], (3,), 0.0, math.pi), _u(k[1], (3,), -100, 100),
                _u(k[2], (n, 2), 0.0, 1.0), _u(k[3], (n, 3), 0.0, math.pi),
                _u(k[4], (n, 3), -100, 100), np.asarray(jax.random.normal(k[5], (n, 2)))]
    k = jax.random.split(key, 8)
    return [_u(k[0], (3,), 0.0, math.pi), _u(k[1], (3,), -100, 100),
            _u(k[2], (2,), -1.0, 1.0), _u(k[3], (), -100, 100),
            _u(k[4], (n, 2), 0.0, 1.0), _u(k[5], (n, 3), 0.0, math.pi),
            _u(k[6], (n, 3), -100, 100), np.asarray(jax.random.normal(k[7], (n, 2)))]


JAX_MAKE = {"crosswire": jsyn.make_crosswire_data, "pointer": jsyn.make_pointer_data,
            "plane_phantom": jsyn.make_plane_phantom_data}
PORT_MAKE = {"crosswire": synthetic.make_crosswire_data, "pointer": synthetic.make_pointer_data,
             "plane_phantom": synthetic.make_plane_phantom_data}
PORT_BUILD = {"crosswire": synthetic._crosswire_from_draws,
              "pointer": synthetic._pointer_from_draws,
              "plane_phantom": synthetic._plane_phantom_from_draws}


def _leaves(x):
    """Flatten a (nested) tuple/dict of arrays or tensors into numpy leaves."""
    if isinstance(x, dict):
        return [leaf for key in sorted(x) for leaf in _leaves(x[key])]
    if isinstance(x, tuple):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def _true_residual(kind, clean, truth):
    """The port estimator's residual at the true minimal parameters."""
    rot = torch.stack(usc._extract_euler_plus(truth["r3"]))
    m = torch.tensor([synthetic.M_X, synthetic.M_Y], dtype=torch.float64)
    if kind == "crosswire":
        return usc._crosswire_residual(torch.cat([truth["t1"], truth["t3"], rot, m]), clean)
    if kind == "pointer":
        return usc._pointer_residual(torch.cat([truth["t3"], rot, m]), clean)
    x = torch.cat([truth["w1"], truth["t1_z"].reshape(1), truth["t3"], rot, m])
    return usc._plane_phantom_residual(x, clean)


@pytest.mark.parametrize("kind", sorted(JAX_MAKE))
def test_build_stage_equals_jax_on_its_draws(kind):
    key = jax.random.PRNGKey(11)
    want = JAX_MAKE[kind](key, n=N, sigma=SIGMA)
    draws = [torch.as_tensor(d.copy()) for d in _jax_draws(kind, key, N)]
    got = PORT_BUILD[kind](*draws, SIGMA)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", sorted(PORT_MAKE))
def test_port_generator_is_seeded_f64_and_satisfies_its_truth(kind):
    gen = torch.Generator().manual_seed(3)
    noisy, clean, truth = PORT_MAKE[kind](gen, n=N, sigma=SIGMA, device="cpu")
    again = PORT_MAKE[kind](torch.Generator().manual_seed(3), n=N, sigma=SIGMA, device="cpu")
    for a, b in zip(_leaves((noisy, clean, truth)), _leaves(again)):
        np.testing.assert_array_equal(a, b)
    frames = clean[0]
    assert frames.r.shape == (N, 3, 3) and frames.t.shape == (N, 3)
    assert all(leaf.dtype == np.float64 for leaf in _leaves((noisy, clean, truth)))
    noise = (noisy[1] - clean[1]).numpy()
    assert noise.shape == (N, 2) and 0.3 * SIGMA < noise.std() < 2.0 * SIGMA
    res = _true_residual(kind, clean, truth)
    assert float(res.abs().max()) < RESIDUAL_TOL


def test_generators_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic.make_pointer_data(None, n=8)
