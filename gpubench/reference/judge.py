"""The comparison that decides ``correct``, and the reference RANSAC itself.

A fit's outputs are judged stage by stage against the plain reference of
its configuration (``gpubench/reference/<name>.py``), in float64:

* ``winner_gap``: the best consensus size over the sweep's whole
  hypothesis set (rebuilt from the fit's seed by the sampling design the
  configuration names, :func:`design`), less the size the reference's
  agreement gives the fit's winning minimal params;
* ``agree_gap``: points where the fit's consensus differs from the
  reference's agreement with that winner, or the reported count from the
  reference's, whichever is larger;
* ``refit_gap``: the largest ``|p - p_ref| / max(|p_ref|, 1)`` over the
  params, with ``p_ref`` the reference's refit of the fit's consensus;
  1e300 where the two disagree on validity.

:func:`reference_fit` runs the whole reference in another dtype and returns
outputs of the same form, so a lower precision put in the program's place
(the control) is judged the same way.
"""

import importlib

import numpy as np
import torch

NUMBERS = ("winner_gap", "agree_gap", "refit_gap")

# Hypothesis-point cells per chunk of the reference sweep.
CHUNK_CELLS = 1 << 26


def _plain_matmul():
    """Float32 matrix products in full float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model(name):
    return importlib.import_module(f"gpubench.reference.{name}")


def design(sampling="fused"):
    """The ``hypothesis_indices`` of the sampling design ``sampling``, a
    configuration's ``sampling`` key: ``fused`` is :mod:`.sampling`, any
    other ``X`` the file ``reference/sampling_X.py``."""
    name = "sampling" if sampling == "fused" else f"sampling_{sampling}"
    return importlib.import_module(f"gpubench.reference.{name}").hypothesis_indices


def sweep_best(ref, data, delta, seed, hypotheses, device, sampling="fused"):
    """``(best count, its minimal params)`` over the hypothesis set of a
    sweep seeded with ``seed`` in the design ``sampling``; the minimal fits
    and votes in the data's dtype."""
    feats = ref.features(data)
    best, best_params = -1, None
    for idx in design(sampling)(seed, feats.shape[0], ref.K, hypotheses, device, CHUNK_CELLS):
        params, valid = ref.minimal_fit(feats[idx])
        counts = torch.where(valid, ref.vote_counts(params, data, delta), -1)
        i = int(torch.argmax(counts))
        if int(counts[i]) > best:
            best, best_params = int(counts[i]), params[i]
    return best, best_params


def judge(ref, data, delta, seed, hypotheses, ls_type, out, device, sampling="fused"):
    """Readings of one fit.  ``out``: ``minimal``, ``consensus``,
    ``best_count``, ``params``, ``valid`` as the fit returned them."""
    _plain_matmul()
    data = ref.cast(data, torch.float64)
    best, _ = sweep_best(ref, data, delta, seed, hypotheses, device, sampling)
    winner = torch.as_tensor(np.asarray(out["minimal"], np.float64), device=device)
    mask_ref = ref.agree(winner, data, delta)
    count_ref = int(mask_ref.sum())
    mask = torch.as_tensor(np.asarray(out["consensus"], bool), device=device)
    params_ref, valid_ref = ref.refit(data, mask, ls_type)
    p_ref = params_ref.cpu().numpy()
    p = np.asarray(out["params"], np.float64)
    if bool(out["valid"]) != valid_ref:
        refit_gap = 1e300
    else:
        refit_gap = float(np.max(np.abs(p - p_ref) / np.maximum(np.abs(p_ref), 1.0)))
    return {
        "winner_gap": best - count_ref,
        "agree_gap": max(int((mask != mask_ref).sum()), abs(int(out["best_count"]) - count_ref)),
        "refit_gap": refit_gap,
    }


def reference_fit(ref, data, delta, seed, hypotheses, ls_type, device, dtype,
                  sampling="fused"):
    """The whole fit computed by the reference in ``dtype``, as outputs of
    the form :func:`judge` takes."""
    _plain_matmul()
    data = ref.cast(data, dtype)
    _, winner = sweep_best(ref, data, delta, seed, hypotheses, device, sampling)
    mask = ref.agree(winner, data, delta)
    params, valid = ref.refit(data, mask, ls_type)
    return {
        "minimal": winner.double().cpu().numpy(),
        "consensus": mask.cpu().numpy(),
        "best_count": int(mask.sum()),
        "params": params.double().cpu().numpy(),
        "valid": valid,
    }
