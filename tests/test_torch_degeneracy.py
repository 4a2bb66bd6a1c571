"""Degenerate-input hardening of the port (counterpart of
``tests/test_degeneracy.py``).

The reference's failure handling is numerical: SVD rank gates and the empty
parameter vector (``PlanePhantom...cxx:205-218``).  The same numpy inputs go
to the JAX package and the port:

  * translation-only pose sets (one rotation for every pose) and a set with
    two rotations collapse the plane phantom's 31-unknown system: the f64
    ``minimal_fit`` is invalid in both packages and the port's parameters
    stay finite; the port's f32 fast path (the phantom subspace stage and its
    Rayleigh-Ritz rank gate) gives every such sample count -1 with finite
    parameters; a crosswire sample of translation-only poses is invalid too;
  * at n = 60,000 the "auto" sampler switches from the exact ``[B, n]``
    subset draw to drawing with replacement, and ``ransac_adaptive``'s
    gathered rounds still recover a 2D line;
  * two structured-sample calls with different permutations overlap at about
    chance level (the shift table is fixed per (n, k, groups)).
"""

import jax.numpy as jnp
import numpy as np
import torch

from lsqrrecipes_tpu.estimators.us_calibration import (
    CrosswireUSCalibrationEstimator as JCrosswire,
)
from lsqrrecipes_tpu.estimators.us_calibration import (
    PlanePhantomUSCalibrationEstimator as JPhantom,
)
from lsqrrecipes_tpu.geometry import Frame as JFrame
from lsqrrecipes_tpu_torch.estimators import (
    CrosswireUSCalibrationEstimator,
    Line2DEstimator,
    PlanePhantomUSCalibrationEstimator,
)
from lsqrrecipes_tpu_torch.estimators.us_calibration import _euler_zyx_matrix
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.ransac import engine, sampling

torch.set_num_threads(2)


def _translation_only_poses(seed, n):
    """Every pose shares one rotation (the tracked probe never rotated):
    ``(r2 [n, 3, 3], t2 [n, 3], q [n, 2])`` float64."""
    rng = np.random.default_rng(seed)
    r = _euler_zyx_matrix(*(torch.tensor(w, dtype=torch.float64) for w in (0.3, -0.8, 1.2)))
    r2 = np.broadcast_to(r.numpy(), (n, 3, 3)).copy()
    t2 = rng.uniform(-100, 100, (n, 3))
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    return r2, t2, q


def _both(r2, t2, q):
    """The same data for the port and for the JAX package."""
    return ((Frame(torch.as_tensor(r2), torch.as_tensor(t2)), torch.as_tensor(q)),
            (JFrame(jnp.asarray(r2), jnp.asarray(t2)), jnp.asarray(q)))


def test_plane_phantom_rank_gate_translation_only():
    tdata, jdata = _both(*_translation_only_poses(0, 31))
    params, valid = PlanePhantomUSCalibrationEstimator(1.0).minimal_fit(tdata)
    _, jvalid = JPhantom(1.0).minimal_fit(jdata)
    assert not bool(valid) and not bool(jvalid)
    assert bool(torch.isfinite(params).all())        # masked lanes stay NaN-free


def test_plane_phantom_rank_gate_two_rotations():
    # Two distinct rotations are still far short of exciting 31 unknowns.
    r2, t2, q = _translation_only_poses(1, 31)
    r2[16:] = _euler_zyx_matrix(*(torch.tensor(w, dtype=torch.float64)
                                  for w in (1.0, 0.2, -0.5))).numpy()
    tdata, jdata = _both(r2, t2, q)
    _, valid = PlanePhantomUSCalibrationEstimator(1.0).minimal_fit(tdata)
    _, jvalid = JPhantom(1.0).minimal_fit(jdata)
    assert not bool(valid) and not bool(jvalid)


def test_plane_phantom_fast_path_rank_gate_translation_only():
    """The f32 fast path gates the rank-collapse cases its f64 twin does."""
    tdata, _ = _both(*_translation_only_poses(3, 40))
    est = PlanePhantomUSCalibrationEstimator(1.0)
    idx = torch.stack([(torch.arange(31) + 3 * i) % 40 for i in range(8)])
    counts, params = est.fit_and_vote(engine._gather(tdata, idx), tdata)
    assert counts.shape == (8,) and bool((counts == -1).all())
    assert bool(torch.isfinite(params).all())


def test_crosswire_rank_gate_translation_only():
    tdata, jdata = _both(*_translation_only_poses(2, 4))
    params, valid = CrosswireUSCalibrationEstimator(3.0).minimal_fit(tdata)
    _, jvalid = JCrosswire(3.0).minimal_fit(jdata)
    assert not bool(valid) and not bool(jvalid)
    assert bool(torch.isfinite(params).all())


def test_adaptive_auto_sampler_large_n():
    """At n = 60,000 an exact subset draw would be a [512, n] uniform matrix
    (~31M cells); the auto sampler draws with replacement instead, and the
    adaptive driver's gathered rounds (which draw through it) still recover
    the line."""
    n, batch = 60_000, 512
    assert batch * n > engine._EXACT_SAMPLING_CELLS     # the switch engages
    idx = engine._sample(torch.Generator().manual_seed(0), n, 2, batch, "auto")
    assert idx.shape == (batch, 2) and int(idx.min()) >= 0 and int(idx.max()) < n

    rng = np.random.default_rng(3)
    t = rng.uniform(-40, 40, (n, 1))
    pts = np.array([-2.0, 5.0]) + t * np.array([0.8, 0.6]) + 0.1 * rng.normal(size=(n, 2))
    pts[-n // 5:] = rng.uniform(-40, 40, (n // 5, 2))
    res = engine.ransac_adaptive(Line2DEstimator(0.5), pts, torch.Generator().manual_seed(4),
                                 batch_size=batch, max_hypotheses=2048, path="gather",
                                 device="cpu")
    assert bool(res.valid)
    assert float(res.inlier_fraction) > 0.7


def test_structured_samples_cross_call_decorrelation():
    """The per-call randomness rides on the permutation alone; two calls'
    hypothesis sets overlap near chance level, and within a call all pairs
    are distinct observations."""
    n, groups, k = 128, 2, 2
    data = torch.arange(n, dtype=torch.float64)[:, None]

    def hyp_set(seed):
        s = sampling.structured_samples(torch.Generator().manual_seed(seed), data, k, groups)
        pairs = s[..., 0].to(torch.int64).numpy()                # [groups * n, k]
        return {tuple(sorted(row)) for row in pairs}

    a, b = hyp_set(0), hyp_set(1)
    # Chance level: |a| |b| / C(n, 2) ~ 256^2 / 8128 ~ 8 collisions.
    assert len(a & b) < groups * n // 4
    assert all(x != y for (x, y) in a)
