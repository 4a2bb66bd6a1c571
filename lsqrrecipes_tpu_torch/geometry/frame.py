"""Rigid transforms as batched tensors (counterpart of
``lsqrrecipes_tpu/geometry/frame.py``).

A ``Frame`` is a ``NamedTuple`` of a rotation block ``r[..., 3, 3]`` and a
translation ``t[..., 3]``, so a stack of tracked-tool poses is one Frame and
every operation broadcasts over leading axes.  The mutating API of the
reference's ``common/Frame.{h,cxx}`` (``Frame.cxx:208-464``) becomes methods
that return new values.
"""

from typing import NamedTuple

import torch

from lsqrrecipes_tpu_torch.geometry import rotations


def _like(x, ref):
    """``x`` as a tensor on ``ref``'s device (its own dtype kept)."""
    return torch.as_tensor(x, device=ref.device)


class Frame(NamedTuple):
    """Rigid transform ``p -> r @ p + t`` with any batch dimensions."""

    r: torch.Tensor  # [..., 3, 3] rotation
    t: torch.Tensor  # [..., 3] translation

    # ------------------------------------------------------------------ build
    @staticmethod
    def identity(batch_shape=(), dtype=torch.float64, device=None):
        r = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
        return Frame(r, torch.zeros((*batch_shape, 3), dtype=dtype, device=device))

    @staticmethod
    def from_quaternion(q, t, normalize=False):
        """From quaternion ``[..., 4]`` (s first) and translation ``[..., 3]``."""
        q = torch.as_tensor(q)
        if normalize:
            q = rotations.normalize_quaternion(q)
        return Frame(rotations.matrix_from_quaternion(q), _like(t, q))

    @staticmethod
    def from_euler_zyx(ax, ay, az, t):
        r = rotations.matrix_from_euler_zyx(*(torch.as_tensor(a) for a in (ax, ay, az)))
        return Frame(r, _like(t, r))

    @staticmethod
    def from_axis_angle(axis, angle, t):
        r = rotations.matrix_from_axis_angle(torch.as_tensor(axis), angle)
        return Frame(r, _like(t, r))

    @staticmethod
    def from_axis_angle_vector(w, t):
        r = rotations.matrix_from_axis_angle_vector(torch.as_tensor(w))
        return Frame(r, _like(t, r))

    # ------------------------------------------------------------------ apply
    def apply(self, p):
        """Transform points ``p[..., 3]`` -> ``r @ p + t`` (``Frame.cxx:208``)."""
        return torch.einsum("...ij,...j->...i", self.r, _like(p, self.r)) + self.t

    def apply_vector(self, v):
        """Rotate vectors, translation ignored (``Frame.cxx:281-300``)."""
        return torch.einsum("...ij,...j->...i", self.r, _like(v, self.r))

    def apply_inverse(self, p):
        """``r^T @ (p - t)`` (``Frame.cxx:240-260``)."""
        return torch.einsum("...ji,...j->...i", self.r, _like(p, self.r) - self.t)

    def apply_inverse_vector(self, v):
        return torch.einsum("...ji,...j->...i", self.r, _like(v, self.r))

    # ---------------------------------------------------------------- algebra
    def compose(self, other: "Frame") -> "Frame":
        """``self o other``: apply ``other`` first (``Frame.cxx:372-422``)."""
        r = torch.einsum("...ij,...jk->...ik", self.r, other.r)
        t = torch.einsum("...ij,...j->...i", self.r, other.t) + self.t
        return Frame(r, t)

    def __matmul__(self, other: "Frame") -> "Frame":
        return self.compose(other)

    def inverse(self) -> "Frame":
        """Rigid inverse ``(r^T, -r^T t)`` (``Frame.cxx:424-464``)."""
        rt = torch.swapaxes(self.r, -1, -2)
        return Frame(rt, -torch.einsum("...ij,...j->...i", rt, self.t))

    # ------------------------------------------------------------ conversions
    def quaternion(self):
        """Unit quaternion ``[..., 4]``, scalar first (``Frame.cxx:952-988``)."""
        return rotations.quaternion_from_matrix(self.r)

    def euler_zyx(self):
        """Both Euler-ZYX solutions ``[..., 6]`` and the gimbal flag."""
        return rotations.euler_zyx_from_matrix(self.r)

    def axis_angle(self):
        """``(angle[...], axis[..., 3])`` (``Frame.cxx:916-950``)."""
        return rotations.axis_angle_from_matrix(self.r)

    # ---------------------------------------------------------- interpolation
    def lerp(self, other: "Frame", t) -> "Frame":
        """Normalised-quaternion and translation lerp (``Frame.cxx:466-492``)."""
        q = rotations.quaternion_lerp(self.quaternion(), other.quaternion(), t)
        tt = torch.as_tensor(t, dtype=self.t.dtype, device=self.t.device)[..., None]
        return Frame.from_quaternion(q, (1.0 - tt) * self.t + tt * other.t)

    def slerp(self, other: "Frame", t) -> "Frame":
        """Quaternion slerp and translation lerp (``Frame.cxx:520-592``)."""
        q = rotations.quaternion_slerp(self.quaternion(), other.quaternion(), t)
        tt = torch.as_tensor(t, dtype=self.t.dtype, device=self.t.device)[..., None]
        return Frame.from_quaternion(q, (1.0 - tt) * self.t + tt * other.t)

    # ----------------------------------------------------------------- deltas
    def angle_and_translation_diff(self, other: "Frame"):
        """``(|dt|[..., 3], angle[...])`` of ``other^-1 o self`` against the
        identity (``Frame.cxx:1016-1059``)."""
        delta = other.inverse().compose(self)
        angle, _ = delta.axis_angle()
        return torch.abs(delta.t), torch.abs(angle)

    def euler_and_translation_diff(self, other: "Frame"):
        """Per-axis |translation| and |Euler-ZYX| differences and validity,
        False when either frame is gimbal locked (``Frame.cxx:981-1014``)."""
        a_self, lock_a = self.euler_zyx()
        a_other, lock_b = other.euler_zyx()
        dt = torch.abs(self.t - other.t)
        da = torch.abs(a_self[..., :3] - a_other[..., :3])
        return dt, da, ~(lock_a | lock_b)
