"""OpenInventor ASCII scene writer (counterpart of
``lsqrrecipes_tpu/viz/inventor.py``, with the same text for the same
values).

The reference's examples and ``RayBundle`` write Coin3D-compatible `.iv`
scenes showing data points (green inliers / red outliers) and the estimated
geometric object (``examples/lineEstimation.cxx:43-48``,
``common/Ray3D.cxx:78-107``).  This is the equivalent scene builder;
viewable with any Open Inventor / Coin3D viewer.  Values may be numpy
arrays, sequences or tensors on any device.
"""

import numpy as np
import torch

HEADER = "#Inventor V2.1 ascii\n\n"

GREEN = (0.0, 1.0, 0.0)
RED = (1.0, 0.0, 0.0)
WHITE = (1.0, 1.0, 1.0)


def _np(x, dtype=None):
    """``x`` as a numpy array (a tensor is copied to the host first)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    elif isinstance(x, (list, tuple)):
        x = [_np(v) for v in x]
    return np.asarray(x, dtype)


class InventorScene:
    def __init__(self):
        self._parts = []

    # ---------------------------------------------------------------- parts
    def add_points(self, points, color=WHITE, radius=1.0):
        """Spheres at each 3D point."""
        points = _np(points)
        lines = ["Separator {", _material(color)]
        for p in points:
            lines += [
                "\tSeparator {",
                "\t\tTransform {",
                f"\t\t\ttranslation {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}",
                "\t\t}",
                f"\t\tSphere {{ radius {float(radius):.6g} }}",
                "\t}",
            ]
        lines.append("}")
        self._parts.append("\n".join(lines))
        return self

    def add_classified_points(self, points, inlier_mask, radius=1.0):
        """Green inliers, red outliers — the examples' convention."""
        mask = _np(inlier_mask, bool)
        points = _np(points)
        self.add_points(points[mask], GREEN, radius)
        self.add_points(points[~mask], RED, radius)
        return self

    def add_polyline(self, vertices, color=WHITE):
        vertices = _np(vertices)
        coord = ",\n".join(
            f"\t\t\t{v[0]:.6g}\t{v[1]:.6g}\t{v[2]:.6g}" for v in vertices
        )
        idx = ", ".join(str(i) for i in range(len(vertices))) + ", -1"
        self._parts.append(
            "Separator {\n"
            + _material(color)
            + "\tCoordinate3 {\n\t\tpoint [\n"
            + coord
            + "\n\t\t]\n\t}\n"
            + "\tIndexedLineSet {\n\t\tcoordIndex [ "
            + idx
            + " ]\n\t}\n}"
        )
        return self

    def add_line_segment(self, point, direction, half_length, color=WHITE):
        p = _np(point)
        n = _np(direction)
        n = n / np.linalg.norm(n)
        h = float(half_length)
        self.add_polyline([p - h * n, p + h * n], color)
        return self

    def add_sphere(self, center, radius, color=WHITE):
        c = _np(center)
        self._parts.append(
            "Separator {\n"
            + _material(color, transparency=0.6)
            + "\tTransform {\n"
            + f"\t\ttranslation {c[0]:.6g} {c[1]:.6g} {c[2]:.6g}\n"
            + "\t}\n"
            + f"\tSphere {{ radius {float(radius):.6g} }}\n"
            + "}"
        )
        return self

    def add_ray_bundle(self, origin, directions, ray_length=100.0, color=WHITE):
        """Shared-origin ray fan, like ``RayBundle::writeOIVData``
        (``Ray3D.cxx:78-107``)."""
        p = _np(origin)
        dirs = _np(directions)
        coords = [p] + [p + float(ray_length) * d for d in dirs]
        coord_txt = ",\n".join(
            f"\t\t\t{v[0]:.6g}\t{v[1]:.6g}\t{v[2]:.6g}" for v in coords
        )
        idx = "\n".join(f"\t\t\t0, {i + 1}, -1," for i in range(len(dirs)))
        self._parts.append(
            "Separator {\n"
            + _material(color)
            + "\tSeparator {\n"
            + "\t\tTransform {\n"
            + f"\t\t\ttranslation {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}\n"
            + "\t\t}\n"
            + "\t\tSphere { radius 10 }\n"
            + "\t}\n"
            + "\tCoordinate3 {\n\t\tpoint [\n"
            + coord_txt
            + "\n\t\t]\n\t}\n"
            + "\tIndexedLineSet {\n\t\tcoordIndex [\n"
            + idx
            + "\n\t\t]\n\t}\n}"
        )
        return self

    # ---------------------------------------------------------------- write
    def write(self, path):
        with open(path, "w") as f:
            f.write(HEADER)
            f.write("\n".join(self._parts))
            f.write("\n")
        return path


def _material(color, transparency=None):
    extra = (
        f"\t\ttransparency {transparency:.3g}\n" if transparency is not None else ""
    )
    return (
        "\tMaterial {\n"
        + f"\t\tdiffuseColor {color[0]:.3g} {color[1]:.3g} {color[2]:.3g}\n"
        + extra
        + "\t}\n"
    )
