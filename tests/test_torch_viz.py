"""Port parity: ``lsqrrecipes_tpu_torch.viz.InventorScene`` vs the JAX
package's writer.  Every method, given the same numpy values (and the same
values as tensors), must write exactly the JAX writer's text."""

import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.viz import InventorScene as JScene
from lsqrrecipes_tpu_torch.viz import InventorScene


def _values(seed):
    rng = np.random.default_rng(seed)
    return {
        "points": rng.uniform(-100, 100, (7, 3)),
        "mask": rng.uniform(size=7) < 0.6,
        "vertices": rng.normal(size=(4, 3)) * 30.0,
        "point": rng.normal(size=3),
        "direction": rng.normal(size=3),
        "center": rng.uniform(-50, 50, 3),
        "radius": float(rng.uniform(5, 30)),
        "directions": rng.normal(size=(5, 3)),
    }


CALLS = {
    "add_points": lambda s, v: s.add_points(v["points"], (0.5, 0.25, 1.0), v["radius"]),
    "add_classified_points": lambda s, v: s.add_classified_points(v["points"], v["mask"], 2.5),
    "add_polyline": lambda s, v: s.add_polyline(v["vertices"], (1.0, 0.0, 0.0)),
    "add_line_segment": lambda s, v: s.add_line_segment(v["point"], v["direction"], 150.0),
    "add_sphere": lambda s, v: s.add_sphere(v["center"], v["radius"]),
    "add_ray_bundle": lambda s, v: s.add_ray_bundle(v["point"], v["directions"], 75.0),
}


def _tensors(values):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else torch.tensor(v)
            for k, v in values.items()}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("method", sorted(CALLS))
def test_scene_text_equals_jax(tmp_path, method, as_tensor):
    values = _values(sorted(CALLS).index(method))
    want = CALLS[method](JScene(), values).write(tmp_path / "jax.iv")
    got = CALLS[method](InventorScene(), _tensors(values) if as_tensor else values)
    got.write(tmp_path / "port.iv")
    text = (tmp_path / "port.iv").read_text()
    assert text == (tmp_path / "jax.iv").read_text()
    assert text.startswith("#Inventor") and text.count("{") == text.count("}") > 0
    assert want == tmp_path / "jax.iv"


def test_whole_scene_equals_jax(tmp_path):
    values = _values(99)
    jax_scene, port_scene = JScene(), InventorScene()
    for method in sorted(CALLS):
        CALLS[method](jax_scene, values)
        CALLS[method](port_scene, _tensors(values))
    jax_scene.write(tmp_path / "jax.iv")
    port_scene.write(tmp_path / "port.iv")
    assert (tmp_path / "port.iv").read_text() == (tmp_path / "jax.iv").read_text()
