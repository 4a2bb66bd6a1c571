"""Port parity: ``lsqrrecipes_tpu_torch.parallel`` on ``torch.distributed``
vs ``lsqrrecipes_tpu.parallel`` on a virtual CPU mesh.

The port's ranks are real processes: 4 (and 2) gloo ranks spawned with
``torch.multiprocessing``, joined through a ``file://`` store in the test's
temporary directory (no TCP port), each with one thread and a 60 s
collective timeout; every join is bounded and kills the ranks on expiry.
One spawn computes every case and each rank writes its results; the tests
then hold rank 0's against the JAX package (run here, on the conftest's
virtual CPU devices, with the same indices, permutations and mesh shape)
and every rank's against rank 0's, since results are replicated.  The
worker functions live at module level and this module imports JAX only
inside the tests, so the ranks never load it.

Tolerances: ``sharded_ransac`` equal count and consensus, params atol
1e-9; ``sharded_lsq_fit`` atol 1e-9; ``sharded_us_feature_lm`` rtol 1e-8
and atol 1e-8 (the JAX test's atol is 1e-9, on other data: on this data
the JAX package's own sharded refit leaves its unsharded one by 2.4e-9 at
8 shards, the LM's stopping noise); ``sharded_us_sweep`` and ``sharded_fused_sweep`` exactly
equal to the port's single-device sweep on the same hypotheses, and to the
JAX package as the single-device parity tests hold them (US counts within
2 with equal maxima; the fused count within 1, JAX's winner the port's
winning hypothesis, its params within 1e-4 relative).
"""

import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from lsqrrecipes_tpu_torch import parallel
from lsqrrecipes_tpu_torch.parallel import sharded

SHAPES = ((4, 1), (2, 2))
US_KINDS = ("crosswire", "pointer", "plane_phantom")
FEATURES = {"pointer": 6, "crosswire": 15, "plane_phantom": 31}
N_US = 64
US_GROUPS = 8
FUSED_N, FUSED_GROUPS, FUSED_SUBSAMPLE = 256, 8, 128
# Refits of float32 clouds 1e4 from the origin (test_torch_far_refits.py's
# models) on 2 ranks: the plane and the absolute-orientation pair take the
# stats route, the sphere the lsq_fit route on the gathered consensus.
FAR_CASES = {"plane": ("PlaneEstimator", (1.0, 3)),
             "absolute_orientation": ("AbsoluteOrientationEstimator", (1.0,)),
             "sphere": ("SphereEstimator", (1.0, 3, "algebraic"))}
FAR_N, FAR_OFFSET = 256, 1e4
JOIN_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# Inputs (numpy, made from seeds)


def line_cloud(seed, n_in=72, n_out=24):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-40.0, 40.0, (n_in, 1))
    inl = np.array([-2.0, 5.0]) + t * np.array([0.8, 0.6]) + 0.3 * rng.normal(size=(n_in, 2))
    return np.concatenate([inl, rng.uniform(-40.0, 40.0, (n_out, 2))])


def sphere_cloud(seed, n_in=96, n_out=32):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    return np.concatenate([inl, rng.uniform(-40.0, 40.0, (n_out, 3))])


def quat_matrix(q):
    s, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - s * z), 2 * (x * z + s * y)], -1),
        np.stack([2 * (x * y + s * z), 1 - 2 * (x * x + z * z), 2 * (y * z - s * x)], -1),
        np.stack([2 * (x * z - s * y), 2 * (y * z + s * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def pivot_frames(seed, n=64):
    """Poses about t_D = (1, 2, 3), t_W = (-5, 4, 10) with N(0, 0.01) noise
    (``tests/test_parallel.py``'s pivot case) -> ``(r, t)``."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    r = quat_matrix(q / np.linalg.norm(q, axis=1, keepdims=True))
    t = np.array([-5.0, 4.0, 10.0]) - r @ np.array([1.0, 2.0, 3.0])
    return r, t + 0.01 * rng.normal(size=t.shape)


def subsets(seed, n, k, b):
    """``b`` distinct-within-a-row k-subsets of ``range(n)``."""
    return np.argsort(np.random.default_rng(seed).uniform(size=(b, n)), axis=1)[:, :k]


RANSAC_CASES = {   # name: (estimator, data, k, hypotheses)
    "line2d": (("Line2DEstimator", (1.5,)), lambda: line_cloud(1), 2, 2048),
    "sphere": (("SphereEstimator", (1.0, 3)), lambda: sphere_cloud(11), 4, 2048),
    "pivot": (("PivotCalibrationEstimator", (1.0,)), lambda: pivot_frames(21), 3, 512),
}


def us_inputs():
    """``{kind: (numpy data tuple ("kind", r, t, q[, p]), delta)}``."""
    from test_torch_stats_lm import phantom_np
    from test_torch_us_calibration import make_us_data

    out = {kind: (make_us_data(kind, 50 + i, N_US)[0], 3.0)
           for i, kind in enumerate(("crosswire", "pointer"))}
    out["plane_phantom"] = (phantom_np(52, N_US, sigma=0.5), 1.0)
    return out


# ---------------------------------------------------------------------------
# The ranks


def _join_group(rank, world, store):
    torch.set_num_threads(1)
    parallel.initialize_distributed(f"file://{store}", world, rank, device_type="cpu",
                                    timeout=datetime.timedelta(seconds=60))


def _torch_data(data):
    """A numpy input -> the port's tree: an array, ``("frame", r, t)`` or an
    ultrasound ``("kind", r, t, q[, p])`` tuple."""
    from lsqrrecipes_tpu_torch.geometry import Frame

    if not isinstance(data, tuple):
        return torch.as_tensor(data)
    _, r, t, *rest = data
    frame = Frame(torch.as_tensor(r), torch.as_tensor(t))
    return frame if not rest else (frame, *(torch.as_tensor(a) for a in rest))


def _estimator(spec):
    from lsqrrecipes_tpu_torch import estimators

    name, args = spec
    return getattr(estimators, name)(*args)


class _Audit:
    """Counts ``dist.all_reduce`` (op, elements) and ``dist.all_gather``
    calls by wrapping the two functions the port calls."""

    def __init__(self):
        self.reduces, self.gathers = [], 0
        self._reduce, self._gather = torch.distributed.all_reduce, torch.distributed.all_gather

    def __enter__(self):
        def all_reduce(tensor, op=torch.distributed.ReduceOp.SUM, **kw):
            self.reduces.append((str(op), tensor.numel()))
            return self._reduce(tensor, op=op, **kw)

        def all_gather(tensors, tensor, **kw):
            self.gathers += 1
            return self._gather(tensors, tensor, **kw)

        torch.distributed.all_reduce, torch.distributed.all_gather = all_reduce, all_gather
        return self

    def __exit__(self, *exc):
        torch.distributed.all_reduce, torch.distributed.all_gather = self._reduce, self._gather


def _four_rank_worker(rank, world, store, inputs, out_dir):
    from lsqrrecipes_tpu_torch.estimators import us_calibration as tus
    from lsqrrecipes_tpu_torch.linalg import LMConfig
    from lsqrrecipes_tpu_torch.linalg import stats_lm
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
    from lsqrrecipes_tpu_torch.parallel import fused

    _join_group(rank, world, store)
    out = {"world": torch.distributed.get_world_size()}
    default = parallel.default_mesh(device_type="cpu")
    out["mesh/default"] = (tuple(default.shape), tuple(default.mesh_dim_names))
    meshes = {shape: parallel.default_mesh(shape=shape, device_type="cpu") for shape in SHAPES}
    for shape, mesh in meshes.items():
        out[f"mesh/{shape}"] = (tuple(mesh.shape), tuple(mesh.get_coordinate()))

    audit = _Audit()
    with audit:
        for name, (spec, data, idx) in inputs["ransac"].items():
            est = _estimator(spec)
            for shape, mesh in meshes.items():
                res = sharded.build_sharded_ransac_step(est, mesh)(_torch_data(data),
                                                                   torch.as_tensor(idx))
                out[f"ransac/{name}/{shape}"] = {k: getattr(res, k).numpy()
                                                 for k in res._fields}
        ransac_reduces = list(audit.reduces)

        data_mesh = parallel.default_mesh(("data",), device_type="cpu")
        rows = _torch_data(inputs["dense"])
        est = _estimator(("DenseLinearSystemEstimator", (0.5, 5)))
        params, valid = parallel.sharded_lsq_fit(est, rows, mesh=data_mesh)
        out["lsq_fit"] = (params.numpy(), bool(valid))

        lm = {}
        for kind, (data, x0, mask) in inputs["feature_lm"].items():
            start = len(audit.reduces)
            res = sharded.sharded_us_feature_lm(kind, _torch_data(data), torch.as_tensor(x0),
                                                torch.as_tensor(mask), LMConfig(max_iters=200),
                                                mesh=data_mesh)
            single = stats_lm.us_feature_lm(kind, _torch_data(data), torch.as_tensor(x0),
                                            torch.as_tensor(mask), LMConfig(max_iters=200))
            lm[kind] = (res.x.numpy(), bool(res.converged), single.x.numpy(),
                        bool(single.converged), audit.reduces[start:])
        out["feature_lm"] = lm

        hyp_mesh = parallel.default_mesh(("hypotheses",), device_type="cpu")
        for kind, (data, delta, perm) in inputs["us_sweep"].items():
            est = {"crosswire": tus.CrosswireUSCalibrationEstimator,
                   "pointer": tus.PointerUSCalibrationEstimator,
                   "plane_phantom": tus.PlanePhantomUSCalibrationEstimator}[kind](delta)
            data, perm = _torch_data(data), torch.as_tensor(perm)
            counts, params = fused.sharded_us_sweep(kind, est, data, None, US_GROUPS, hyp_mesh,
                                                    perm=perm)
            c1, p1 = est.structured_sweep(data, None, US_GROUPS, perm=perm)
            out[f"us_sweep/{kind}"] = (counts.numpy(), params.numpy(), c1.numpy(), p1.numpy())
            try:                   # 10 groups do not split into 4 whole blocks
                fused.sharded_us_sweep(kind, est, data, None, US_GROUPS + 2, hyp_mesh, perm=perm)
                out[f"us_sweep/{kind}/ragged"] = "no error"
            except ValueError as e:
                out[f"us_sweep/{kind}/ragged"] = str(e)

        pts, perms = inputs["fused"]
        count, params = fused.sharded_fused_sweep("sphere3d", torch.as_tensor(pts), None,
                                                  FUSED_GROUPS, 1.0, hyp_mesh, perms=perms)
        per_rank = fs.fused_sweep("sphere3d", torch.as_tensor(pts), None, FUSED_GROUPS // world,
                                  1.0, perms=perms[rank])
        out["fused"] = (int(count), params.numpy(), int(per_rank[0]), per_rank[1].numpy())
        subsampled = [fused.sharded_fused_sweep(
            "sphere3d", torch.as_tensor(pts), torch.Generator().manual_seed(5), FUSED_GROUPS,
            1.0, hyp_mesh, vote_subsample=FUSED_SUBSAMPLE, perms=perms) for _ in range(2)]
        rank_gen = fused._rank_generator(torch.Generator().manual_seed(5), rank,
                                         torch.device("cpu"))
        per_rank = fs.fused_sweep("sphere3d", torch.as_tensor(pts), rank_gen,
                                  FUSED_GROUPS // world, 1.0, vote_subsample=FUSED_SUBSAMPLE,
                                  perms=perms[rank])
        out["fused/subsample"] = ([(int(c), p.numpy()) for c, p in subsampled],
                                  int(per_rank[0]), per_rank[1].numpy())
    out["audit"] = (audit.reduces, audit.gathers, ransac_reduces)
    torch.distributed.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _two_rank_worker(rank, world, store, inputs, out_dir):
    _join_group(rank, world, store)
    out = {}
    spec, data, idx = inputs["line2d"]
    for shape in ((2, 1), (1, 2)):
        mesh = parallel.default_mesh(shape=shape, device_type="cpu")
        res = parallel.sharded_ransac(_estimator(spec), _torch_data(data),
                                      torch.Generator().manual_seed(3), 1024, mesh)
        step = sharded.build_sharded_ransac_step(_estimator(spec), mesh)
        fixed = step(_torch_data(data), torch.as_tensor(idx))
        out[shape] = ({k: getattr(fixed, k).numpy() for k in fixed._fields}, int(res.best_count),
                      bool(res.valid))
    data_mesh = parallel.default_mesh(("data",), device_type="cpu")
    split_mesh = parallel.default_mesh(shape=(1, 2), device_type="cpu")
    for kind, (spec, leaves, mask, idx) in inputs["far"].items():
        est = _estimator(spec)
        data = tuple(map(torch.as_tensor, leaves)) if len(leaves) == 2 else \
            torch.as_tensor(leaves[0])
        mask = torch.as_tensor(mask)
        if est.has_stats:
            params, valid = parallel.sharded_lsq_fit(est, data, mask, mesh=data_mesh)
            single, _ = est.lsq_fit(data, mask)
            out[f"far/{kind}/lsq_fit"] = (params.numpy(), bool(valid), single.numpy())
        res = sharded.build_sharded_ransac_step(est, split_mesh)(data, torch.as_tensor(idx))
        single, _ = est.lsq_fit(data, res.consensus)
        out[f"far/{kind}/ransac"] = (res.params.numpy(), bool(res.valid), single.numpy())
    torch.distributed.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def spawn(fn, world, out_dir, inputs, timeout=JOIN_TIMEOUT_S):
    """Run ``fn(rank, world, store, inputs, out_dir)`` on ``world`` spawned
    ranks; a rank's exception fails the run, and the join is bounded: on
    expiry every rank is killed.  Returns each rank's pickled results."""
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(fn, args=(world, store, inputs, out_dir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """(inputs, per-rank results) of the 4-rank spawn."""
    import jax
    from test_torch_fused_sweep import _jax_randomness
    from test_torch_stats_lm import analytic_x0
    from test_torch_us_calibration import make_us_data

    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    ransac = {}
    for i, (name, (spec, make, k, b)) in enumerate(RANSAC_CASES.items()):
        data = make()
        if name == "pivot":
            data = ("frame", *data)
        n = len(data[1]) if name == "pivot" else len(data)
        ransac[name] = (spec, data, subsets(30 + i, n, k, b))
    rng = np.random.default_rng(31)
    a = rng.uniform(-1.0, 1.0, (160, 5))
    dense = np.concatenate([a, (a @ np.arange(1.0, 6.0))[:, None]], axis=1)
    us = us_inputs()
    feature_lm = {}
    for kind, (data, _) in us.items():
        clean = data if kind == "plane_phantom" else make_us_data(kind, 4, N_US, outliers=0.0)[0]
        feature_lm[kind] = (clean, analytic_x0(kind, clean), np.arange(N_US) % 5 != 0)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(53), N_US))
    us_sweep = {kind: (data, delta, perm) for kind, (data, delta) in us.items()}
    pts = sphere_cloud(5, 204, 52).astype(np.float32)
    key = jax.random.PRNGKey(9)
    n_fit = fs.fit_size(FUSED_N, 4)
    perms = np.stack([_jax_randomness(jax.random.fold_in(key, r), FUSED_N, n_fit)[0]
                      for r in range(4)])
    inputs = {"ransac": ransac, "dense": dense, "feature_lm": feature_lm, "us_sweep": us_sweep,
              "fused": (pts, perms)}
    return inputs, spawn(_four_rank_worker, 4, str(tmp_path_factory.mktemp("four")), inputs)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    from test_torch_far_refits import far_data, shift

    spec, make, k, _ = RANSAC_CASES["line2d"]
    data = make()
    far = {}
    for i, (kind, spec_far) in enumerate(FAR_CASES.items()):
        leaves, mask = far_data(kind, 60 + i, outliers=True, n=FAR_N)
        leaves = tuple(x.astype(np.float32) for x in shift(kind, leaves, FAR_OFFSET))
        k_far = {"sphere": 4, "plane": 3, "absolute_orientation": 3}[kind]
        far[kind] = (spec_far, leaves, mask, subsets(70 + i, FAR_N, k_far, 256))
    inputs = {"line2d": (spec, data, subsets(40, len(data), k, 1024)), "far": far}
    return inputs, spawn(_two_rank_worker, 2, str(tmp_path_factory.mktemp("two")), inputs)


# ---------------------------------------------------------------------------
# JAX references


def jax_mesh(shape, names=("hypotheses", "data")):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices("cpu")[: int(np.prod(shape))]).reshape(shape), names)


def jax_data(data):
    import jax.numpy as jnp

    from lsqrrecipes_tpu import geometry as jgeo

    if not isinstance(data, tuple):
        return jnp.asarray(data)
    _, r, t, *rest = data
    frame = jgeo.Frame(jnp.asarray(r), jnp.asarray(t))
    return frame if not rest else (frame, *(jnp.asarray(a) for a in rest))


def jax_estimator(spec):
    from lsqrrecipes_tpu import estimators

    name, args = spec
    return getattr(estimators, name)(*args)


def jax_ransac(spec, data, idx, shape):
    import jax.numpy as jnp

    from lsqrrecipes_tpu.parallel.sharded import build_sharded_ransac_step

    step = build_sharded_ransac_step(jax_estimator(spec), jax_mesh(shape))
    return step(jax_data(data), jnp.asarray(idx))


def same_on_every_rank(results, key):
    def flat(v):
        if isinstance(v, dict):
            return [a for k in sorted(v) for a in flat(v[k])]
        if isinstance(v, (tuple, list)):
            return [a for x in v for a in flat(x)]
        return [np.asarray(v)]

    want = flat(results[0][key])
    for rank, res in enumerate(results[1:], 1):
        for a, b in zip(flat(res[key]), want):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} differs on {key}")


def check_ransac(got, want):
    assert bool(got["valid"]) == bool(want.valid) is True
    assert int(got["best_count"]) == int(want.best_count)
    np.testing.assert_array_equal(got["consensus"], np.asarray(want.consensus))
    np.testing.assert_allclose(got["params"], np.asarray(want.params), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["inlier_fraction"], float(want.inlier_fraction), rtol=1e-12)


# ---------------------------------------------------------------------------
# Tests


def test_default_mesh_shapes_and_row_major_ranks(four):
    _, results = four
    for rank, res in enumerate(results):
        assert res["world"] == 4
        assert res["mesh/default"] == ((4, 1), ("hypotheses", "data"))
        assert res[f"mesh/{(4, 1)}"] == ((4, 1), (rank, 0))
        assert res[f"mesh/{(2, 2)}"] == ((2, 2), (rank // 2, rank % 2))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(RANSAC_CASES))
def test_sharded_ransac_matches_jax(four, name, shape):
    inputs, results = four
    spec, data, idx = inputs["ransac"][name]
    key = f"ransac/{name}/{shape}"
    check_ransac(results[0][key], jax_ransac(spec, data, idx, shape))
    same_on_every_rank(results, key)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_two_ranks_match_jax_and_draw_alike(two, shape):
    inputs, results = two
    spec, data, idx = inputs["line2d"]
    fixed, count, valid = results[0][shape]
    check_ransac(fixed, jax_ransac(spec, data, idx, shape))
    assert valid and count >= 60            # 72 inliers, 1,024 hypotheses from one seed
    same_on_every_rank(results, shape)


@pytest.mark.parametrize("kind,route", [
    ("plane", "lsq_fit"), ("plane", "ransac"), ("absolute_orientation", "lsq_fit"),
    ("absolute_orientation", "ransac"), ("sphere", "ransac")])
def test_sharded_refits_far_from_the_origin_equal_unsharded(two, kind, route):
    """The float64 statistics Sum-reduce over 2 ranks and the params come back
    in float32, equal to the unsharded refit of the same mask (rtol 1e-6;
    Horn's translation within one float32 ulp of the offset besides, as in
    ``test_torch_far_refits.py``)."""
    _, results = two
    key = f"far/{kind}/{route}"
    params, valid, single = results[0][key]
    assert valid and params.dtype == single.dtype == np.float32
    if kind == "absolute_orientation":
        q_sign = np.sign(np.dot(params[:4], single[:4]))
        np.testing.assert_allclose(params[:4] * q_sign, single[:4], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(params[4:], single[4:], rtol=1e-6,
                                   atol=1e-6 + float(np.spacing(np.float32(FAR_OFFSET))))
    else:
        sign = np.sign(np.dot(params[:3], single[:3])) if kind == "plane" else 1.0
        np.testing.assert_allclose(np.r_[params[:3] * sign, params[3:]], single, rtol=1e-6,
                                   atol=1e-6)
    same_on_every_rank(results, key)


@pytest.mark.parametrize("kind", US_KINDS)
def test_sharded_us_sweep_matches_single_device_and_jax(four, kind):
    import jax

    from lsqrrecipes_tpu.parallel import sharded_us_sweep as jsharded_us_sweep

    inputs, results = four
    counts, params, c1, p1 = results[0][f"us_sweep/{kind}"]
    assert counts.shape == (US_GROUPS * N_US,)
    np.testing.assert_array_equal(counts, c1)
    np.testing.assert_array_equal(params, p1)
    same_on_every_rank(results, f"us_sweep/{kind}")
    data, delta, _ = inputs["us_sweep"][kind]
    from test_torch_stats_lm import ESTIMATORS

    jest = ESTIMATORS[kind][0](delta)
    cj, _ = jsharded_us_sweep(kind, jest, jax_data(data), jax.random.PRNGKey(53), US_GROUPS,
                              mesh=jax_mesh((4,), ("hypotheses",)))
    cj = np.asarray(cj)
    both = (counts >= 0) & (cj >= 0)
    assert both.mean() > 0.95
    assert np.abs(counts[both] - cj[both]).max() <= 2
    assert int(counts.max()) == int(cj.max()) > N_US // 2


def test_sharded_us_sweep_needs_whole_groups_per_rank(four):
    _, results = four
    for kind in US_KINDS:
        assert "must be divisible" in results[0][f"us_sweep/{kind}/ragged"]


def test_sharded_lsq_fit_matches_jax(four):
    from lsqrrecipes_tpu.parallel import sharded_lsq_fit as jsharded_lsq_fit

    inputs, results = four
    params, valid = results[0]["lsq_fit"]
    pj, vj = jsharded_lsq_fit(jax_estimator(("DenseLinearSystemEstimator", (0.5, 5))),
                              jax_data(inputs["dense"]), mesh=jax_mesh((4,), ("data",)))
    assert valid and bool(vj)
    np.testing.assert_allclose(params, np.asarray(pj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(params, np.arange(1.0, 6.0), rtol=0, atol=1e-9)
    same_on_every_rank(results, "lsq_fit")


@pytest.mark.parametrize("kind", US_KINDS)
def test_sharded_us_feature_lm_matches_jax_and_unsharded(four, kind):
    import jax.numpy as jnp

    from lsqrrecipes_tpu.linalg import LMConfig as JLMConfig
    from lsqrrecipes_tpu.parallel.sharded import sharded_us_feature_lm as jsharded

    inputs, results = four
    x, converged, x1, converged1, _ = results[0]["feature_lm"][kind]
    data, x0, mask = inputs["feature_lm"][kind]
    jres = jsharded(kind, jax_data(data), jnp.asarray(x0), jnp.asarray(mask),
                    config=JLMConfig(max_iters=200), mesh=jax_mesh((4,), ("data",)))
    assert converged and converged1 and bool(jres.converged)
    np.testing.assert_allclose(x, x1, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(x, np.asarray(jres.x), rtol=1e-8, atol=1e-8)


def test_sharded_fused_sweep_matches_per_rank_sweeps_and_jax(four):
    import jax

    from lsqrrecipes_tpu.parallel import sharded_fused_sweep as jsharded_fused
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    inputs, results = four
    count, params = results[0]["fused"][:2]
    per_rank = [(res["fused"][2], res["fused"][3]) for res in results]
    winner = int(np.argmax([c for c, _ in per_rank]))
    assert count == per_rank[winner][0] > FUSED_N // 2
    np.testing.assert_array_equal(params, per_rank[winner][1])
    for res in results:
        assert res["fused"][0] == count
        np.testing.assert_array_equal(res["fused"][1], params)
    pts, perms = inputs["fused"]
    cj, pj = jsharded_fused("sphere3d", pts, jax.random.PRNGKey(9), FUSED_GROUPS, 1.0,
                            mesh=jax_mesh((4,), ("hypotheses",)), interpret=True)
    cj, pj = int(cj), np.asarray(pj)
    assert abs(count - cj) <= 1
    # Locate both winners among every rank's hypotheses: JAX's is the port's
    # winner, its params within 1e-4 relative of the port's f32 fit of that
    # sample (the two packages' f32 circumsphere fits round in another
    # order: 6e-5 apart on this winner).
    fits, port_index = [], None
    for r in range(4):
        coords, p, nf, cols = fs.sweep_inputs("sphere3d", torch.as_tensor(pts), perms=perms[r])
        groups = FUSED_GROUPS // 4
        _, _, index = fs.sweep_plain("sphere3d", coords, p, nf, groups, cols, 1.0)
        samples = fs.reference_samples("sphere3d", torch.as_tensor(pts), perms[r], groups)
        center, radius, _, _ = fs.sphere3d_fit([[samples[:, j, c] for c in range(3)]
                                                for j in range(4)], torch.tensor(1.0))
        if r == winner:
            port_index = sum(len(f) for f in fits) + int(index)
        fits.append(torch.stack(center + [radius], dim=1).numpy())
    fits = np.concatenate(fits)
    np.testing.assert_array_equal(fits[port_index], params)
    gap = np.abs(fits - pj).max(axis=1)
    assert int(np.argmin(gap)) == port_index
    assert gap[port_index] <= 1e-4 * np.abs(pj).max()


def test_sharded_fused_sweep_subsample_votes_in_the_rank_generators_order(four):
    """With ``vote_subsample``, explicit slot-plane ``perms`` leave the vote
    order to each rank's generator: a generator seeded alike repeats the
    sweep, and the winner is the best of the per-rank sweeps with that
    rank's generator, the lowest rank first."""
    _, results = four
    per_rank = [res["fused/subsample"][1:] for res in results]
    winner = int(np.argmax([c for c, _ in per_rank]))
    assert per_rank[winner][0] > FUSED_SUBSAMPLE // 2
    for res in results:
        for count, params in res["fused/subsample"][0]:
            assert count == per_rank[winner][0]
            np.testing.assert_array_equal(params, per_rank[winner][1])


def test_collectives_are_sum_reduces_and_gathers(four):
    """The JAX package lowers only Sum all-reduces and all-gathers
    (``tests/test_collective_audit.py``); so does the port.  The stats-LM
    refit is exactly two all-reduces, of F and F^2 elements."""
    _, results = four
    for res in results:
        reduces, gathers, _ = res["audit"]
        assert reduces and gathers > 0
        assert {op for op, _ in reduces} == {str(torch.distributed.ReduceOp.SUM)}
        for kind, f in FEATURES.items():
            assert [n for _, n in res["feature_lm"][kind][4]] == [f, f * f]


def test_build_sharded_us_feature_lm_needs_the_data_tree():
    with pytest.raises(ValueError, match="data_tree"):
        sharded.build_sharded_us_feature_lm("pointer", torch.zeros(8, dtype=torch.float64))


def test_initialize_distributed_raises_on_a_bad_explicit_store(tmp_path, monkeypatch):
    (tmp_path / "a file").write_text("")
    store = tmp_path / "a file" / "store"          # a store under a file: no such store
    with pytest.raises(RuntimeError):
        parallel.initialize_distributed(f"file://{store}", 2, 0, device_type="cpu",
                                        timeout=datetime.timedelta(seconds=5))
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        parallel.initialize_distributed(num_processes=2, device_type="cpu")
    with pytest.raises(ValueError, match="backend"):
        parallel.initialize_distributed("file:///x", 1, 0, device_type="tpu")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.warns(RuntimeWarning, match="single process"):
        parallel.initialize_distributed(device_type="cpu")
    assert not torch.distributed.is_initialized()


def test_default_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        parallel.default_mesh(device_type="cpu")
