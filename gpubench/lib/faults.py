"""Faults planted in the program underneath a run, each one the check has
to catch: the tests plant them at a small size on the CPU, and
``gpubench/control.py --fault`` at a cell's own size on the card.

Each takes ``patch(obj, name, value)``, which replaces an attribute and
undoes it later (pytest's ``monkeypatch.setattr``, or :class:`Patch`).
"""

import torch


class Patch:
    """``patch(obj, name, value)``; :meth:`undo` puts every original back."""

    def __init__(self):
        self._undo = []

    def __call__(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()


def lm_returns_its_start(patch):
    """Levenberg-Marquardt hands back its start: the refit's state unchanged."""
    from lsqrrecipes_tpu_torch.estimators import sphere, us_calibration
    from lsqrrecipes_tpu_torch.linalg.lm import LMResult

    def unchanged(residual_fn, jac_fn, x0, data, mask=None, config=None):
        z = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
        return LMResult(x0, z, z.to(torch.int32), torch.ones_like(z, dtype=torch.bool))

    patch(sphere, "levenberg_marquardt", unchanged)
    patch(us_calibration, "levenberg_marquardt", unchanged)


def refit_returns_its_input(patch):
    """The consensus refit does nothing: the winning minimal fit is the
    answer (what an ALGEBRAIC or ANALYTIC refit left unchanged gives)."""
    from lsqrrecipes_tpu_torch.ransac import engine

    orig = engine._finalize

    def finalize(est, data, best_count, best_mask, best_params, n):
        res = orig(est, data, best_count, best_mask, best_params, n)
        return res._replace(params=best_params.to(res.params.dtype))

    patch(engine, "_finalize", finalize)


def refit_on_half(patch):
    """The refit sees half of the consensus, its solve taken over the rest."""
    from lsqrrecipes_tpu_torch.ransac import engine

    orig = engine.consensus_refit

    def half(est, data, mask):
        keep = mask.clone()
        keep[torch.nonzero(mask).reshape(-1)[1::2]] = False
        return orig(est, data, keep)

    patch(engine, "consensus_refit", half)


def params_altered(patch):
    """An answer altered where it is produced: one refit parameter moved by
    a hundredth of its size (or of 1)."""
    from lsqrrecipes_tpu_torch.ransac import engine

    orig = engine.consensus_refit

    def altered(est, data, mask):
        params, valid = orig(est, data, mask)
        params = params.clone()
        params[0] += 0.01 * max(1.0, abs(float(params[0])))
        return params, valid

    patch(engine, "consensus_refit", altered)


def winner_altered(patch):
    """An answer altered where it is produced: the sweep returns another
    hypothesis than its best (the sphere grown by 2 delta, the crosswire
    point moved by 2 delta)."""
    from lsqrrecipes_tpu_torch.ops import fused_sweep

    orig = fused_sweep.fused_sweep

    def altered(family, data, *args, **kwargs):
        count, params = orig(family, data, *args, **kwargs)
        params = params.clone()
        params[3 if family == "sphere3d" else 0] += 2.0 * (1.0 if family == "sphere3d" else 3.0)
        return count, params

    patch(fused_sweep, "fused_sweep", altered)


def count_altered(patch):
    """An answer altered where it is produced: the reported consensus size
    a tenth more than the consensus holds."""
    from lsqrrecipes_tpu_torch.ransac import engine

    orig = engine._finalize

    def finalize(est, data, best_count, best_mask, best_params, n):
        res = orig(est, data, best_count, best_mask, best_params, n)
        return res._replace(best_count=res.best_count + res.best_count // 10)

    patch(engine, "_finalize", finalize)


LM_CELLS = ("sphere3d.geometric", "crosswire.iterative")
ALL_CELLS = LM_CELLS + ("sphere3d.algebraic", "crosswire.analytic")

# name -> (plant, the cells that can have it)
FAULTS = {
    "lm_returns_its_start": (lm_returns_its_start, LM_CELLS),
    "refit_returns_its_input": (refit_returns_its_input, ALL_CELLS),
    "refit_on_half": (refit_on_half, ALL_CELLS),
    "params_altered": (params_altered, ALL_CELLS),
    "winner_altered": (winner_altered, ALL_CELLS),
    "count_altered": (count_altered, ALL_CELLS),
}
