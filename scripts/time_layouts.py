#!/usr/bin/env python3
"""Time kernels of the PyTorch/CUDA port at other layouts than the shipped
one, on one NVIDIA GPU.

    python3 scripts/time_layouts.py [case ...]     # every case by default

A case is one kernel and its variants (``CASES``).  A variant is a copy of
``lsqrrecipes_tpu_torch/csrc/`` under ``build/layouts/<case>-<variant>/``
with constexpr constants of the kernel's source set to other values
("shipped" is the tree's own source); every copy is built together (one
``nvcc`` each).  On ``chip_smoke.py``'s data and shapes each variant's run is
checked, then timed: the mean of ``reps`` launches held behind a spin kernel
(``chip_smoke.Timer``), in two rounds, variants in order then reversed.  The
checks are the phases' own: a rigid sweep gives the shipped variant's count,
winner index and params (phase 13), ``sphere_lm`` stays within 1e-3 of its
plain version with every problem converged (phase 18), and
``sphere_planar_vote`` equals its plain version (phase 20).  Per variant it
prints the launch shape and its times; the last line is the card's name and
power limit.
"""

import re
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# case: {variant: [(anchor, constant, value), ...]}: each constant is set at
# its first declaration after `anchor` (or in the whole source) in the
# case's kernel source.
CASES = {
    "pivot": {"shipped": [], "4 per thread": [("struct Pivot {", "kHypPerThread", "4")]},
    "ray3d": {"shipped": [], "4 per thread": [("struct Ray3D {", "kHypPerThread", "4")]},
    "sphere_lm": {
        "shipped": [],
        "32 lanes": [(None, "kLanes", "32")],
        "12 blocks per SM": [(None, "kLmMinBlocks", "12")],   # uncapped: ~150 registers
    },
    "sphere_planar_vote": {
        "shipped": [],
        "4 per thread": [(None, "kPlanarHypPerThread", "4"), (None, "kPlanarMinBlocks", "4")],
        "4 blocks per SM": [(None, "kPlanarMinBlocks", "4")],   # one wave, 64 registers
    },
}


def shipped_kernel(case):
    """The kernel object the case's wrapper looks up on every call."""
    from lsqrrecipes_tpu_torch import kernels

    if case in kernels.FUSED_SWEEPS:
        return kernels.FUSED_SWEEPS[case]
    return getattr(kernels, case.upper())


def install(case, kernel):
    """Make ``kernel`` the one the case's wrapper launches."""
    from lsqrrecipes_tpu_torch import kernels

    if case in kernels.FUSED_SWEEPS:
        kernels.FUSED_SWEEPS[case] = kernel
    else:
        setattr(kernels, case.upper(), kernel)


def variant_kernel(case, variant, edits):
    """A copy of the kernel sources with ``edits`` made, as a Kernel."""
    from lsqrrecipes_tpu_torch import kernels

    shipped = shipped_kernel(case)
    text = shipped.source.read_text()
    for anchor, constant, value in edits:
        pattern = re.compile(rf"constexpr int {constant} = [^;]+;")
        found = pattern.search(text, 0 if anchor is None else text.index(anchor))
        if found is None:
            raise ValueError(f"{shipped.source.name} declares no {constant}")
        text = text[: found.start()] + f"constexpr int {constant} = {value};" + text[found.end():]
    out_dir = ROOT / "build" / "layouts" / f"{case}-{variant.replace(' ', '-')}"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, out_dir)
    (out_dir / shipped.source.name).write_text(text)
    k = kernels.Kernel(shipped.name, shipped.source.name, shipped.symbol, shipped.argtypes)
    k.source = out_dir / shipped.source.name
    return k


def rigid_setup(torch, family, rng, dev):
    from lsqrrecipes_tpu_torch import geometry, interop
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    est, n, groups, _ = chip_smoke.RIGID[family]
    delta = (chip_smoke.DELTA, float(np.sin(chip_smoke.RAY_MIN_ANGLE) ** 2)) \
        if family == "ray3d" else chip_smoke.DELTA
    data = interop.data_to_torch(chip_smoke.rigid_data(rng, family, n, geometry), device=dev)
    coords, p, n_fit, cols = fs.sweep_inputs(family, data, torch.Generator(device=dev)
                                             .manual_seed(0))

    def run(c=cols):
        return fs.sweep_cuda(family, coords, p, n_fit, groups, c, delta)

    first = []

    def agrees(out):   # the shipped variant, checked first, sets the answer
        got = (int(out[0]), int(out[2]), out[1].cpu())
        if not first:
            first.append(got)
        return got[:2] == first[0][:2] and bool(torch.equal(got[2], first[0][2]))

    title = f"{family} ({est}): {groups} groups x {n_fit} lanes x {cols} columns"
    return title, groups * n_fit, run, agrees, {"sweep": run, "on 1 column": lambda: run(1)}, 20


def lm_setup(torch, rng, dev):
    from lsqrrecipes_tpu_torch.ops import sphere_lm

    pts, x0 = (torch.as_tensor(a, device=dev)
               for a in chip_smoke.lm_problems(rng, chip_smoke.LM_B, chip_smoke.LM_M))
    plain_x = sphere_lm.sphere_lm_batch_plain(pts, x0, chip_smoke.LM_ITERS,
                                              gtol=chip_smoke.LM_GTOL)[0]

    def run():
        return sphere_lm.sphere_lm_batch_cuda(pts, x0, chip_smoke.LM_ITERS,
                                              gtol=chip_smoke.LM_GTOL)

    def agrees(out):
        return bool(out[3].all()) and float((out[0] - plain_x).abs().max()) < 1e-3

    title = f"sphere_lm: {chip_smoke.LM_B} problems x {chip_smoke.LM_M} points"
    return title, chip_smoke.LM_B, run, agrees, {"kernel": run}, 10


def planar_setup(torch, rng, dev):
    from lsqrrecipes_tpu_torch.ops import sphere_ransac as sr
    from lsqrrecipes_tpu_torch.ops import vote

    pts = torch.as_tensor(chip_smoke.bench_cloud(rng, chip_smoke.N_MAIN), device=dev)
    points_t, valid, _ = vote.pack_points(pts)
    sxyz = sr.planar_sphere_samples(torch.Generator(device=dev).manual_seed(0), pts,
                                    chip_smoke.SCAN_GROUPS)
    plain = sr.sphere_fit_and_vote_planar_plain(sxyz, points_t, valid, chip_smoke.DELTA)

    def run():
        return sr.sphere_fit_and_vote_planar_cuda(sxyz, points_t, valid, chip_smoke.DELTA)

    def agrees(out):
        return bool(torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1]))

    title = f"sphere_planar_vote: {sxyz.shape[1]} hypotheses x {chip_smoke.N_MAIN} points"
    return title, sxyz.shape[1], run, agrees, {"kernel": run}, 20


def setup(torch, case, rng, dev):
    if case == "sphere_lm":
        return lm_setup(torch, rng, dev)
    if case == "sphere_planar_vote":
        return planar_setup(torch, rng, dev)
    return rigid_setup(torch, case, rng, dev)


def main(argv=None):
    import torch

    cases = list(sys.argv[1:] if argv is None else argv) or list(CASES)
    unknown = [c for c in cases if c not in CASES]
    if unknown:
        print(f"time_layouts: unknown cases {unknown}; known: {list(CASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_layouts: CUDA is not available", file=sys.stderr)
        return 1
    from lsqrrecipes_tpu_torch import kernels

    builds = {(case, v): variant_kernel(case, v, edits)
              for case in cases for v, edits in CASES[case].items()}
    kernels.build_all(list(builds.values()))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    timer = chip_smoke.Timer(torch)
    smi = chip_smoke.nvidia_smi_line()
    for case in cases:
        title, num, run, agrees, timed, reps = setup(torch, case, rng, dev)
        variants = list(CASES[case])
        times = {}
        shipped = shipped_kernel(case)
        for order in (variants, variants[::-1]):
            for v in order:
                install(case, builds[case, v])
                chip_smoke.check(agrees(run()), f"{case} at {v} parts from its reference")
                for label, fn in timed.items():
                    times.setdefault((v, label), []).append(timer.ms(fn, reps=reps))
                install(case, shipped)
        print(title)
        for v in variants:
            runs = "; ".join(f"{label} ms " + ", ".join(f"{ms:.4f}" for ms in times[v, label])
                             for label in timed)
            print(f"  {v}: {chip_smoke.launch_shape(builds[case, v], num)}; {runs}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
