#!/usr/bin/env python3
"""Time the rigid sweeps of the PyTorch/CUDA port at other hypotheses per
thread, on one NVIDIA GPU.

    python3 scripts/time_rigid_layouts.py

For pivot and ray3d and k = 4 and 8, copies ``lsqrrecipes_tpu_torch/csrc/``
into ``build/layouts/<family>-<k>/`` with the family's ``kHypPerThread``
set to k, builds every copy (one ``nvcc`` each, all started together), and on
``chip_smoke.py``'s phase 13 data and shapes prints, per k: the launch
shape, the sweep's ms and its ms on 1 column (the fit, the staging and the
publishing), each the mean of 20 launches held behind a spin kernel
(``chip_smoke.Timer``), timed in two rounds, k ascending then descending.
Every layout must give the same count, winner index and params.  The last
line is the card's name and power limit.
"""

import re
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

STRUCTS = {"pivot": "Pivot", "ray3d": "Ray3D"}   # family: its struct in the source
PER_THREAD = (4, 8)


def layout_source(family, k):
    """A copy of the kernel sources with ``family``'s kHypPerThread = k."""
    from lsqrrecipes_tpu_torch import kernels

    src = kernels.FUSED_SWEEPS[family].source
    text = src.read_text()
    struct = text.index(f"struct {STRUCTS[family]} {{")
    pattern = re.compile(r"static constexpr int kHypPerThread = \d+;")
    found = pattern.search(text, struct)
    if found is None:
        raise ValueError(f"{STRUCTS[family]} declares no kHypPerThread")
    out_dir = ROOT / "build" / "layouts" / f"{family}-{k}"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(src.parent, out_dir)
    (out_dir / src.name).write_text(
        text[: found.start()] + f"static constexpr int kHypPerThread = {k};" + text[found.end():])
    return out_dir / src.name


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_rigid_layouts: CUDA is not available", file=sys.stderr)
        return 1
    from lsqrrecipes_tpu_torch import geometry, interop, kernels
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    variants = {}
    for family in STRUCTS:
        for k in PER_THREAD:
            shipped = kernels.FUSED_SWEEPS[family]
            variant = kernels.Kernel(shipped.name, shipped.source.name, shipped.symbol,
                                     shipped.argtypes)
            variant.source = layout_source(family, k)
            variants[family, k] = variant
    kernels.build_all(list(variants.values()))

    timer = chip_smoke.Timer(torch)
    rng = np.random.default_rng(0)
    smi = chip_smoke.nvidia_smi_line()
    for family in STRUCTS:
        _, n, groups, _ = chip_smoke.RIGID[family]
        est = chip_smoke.RIGID[family][0]
        delta = (chip_smoke.DELTA, float(np.sin(chip_smoke.RAY_MIN_ANGLE) ** 2)) \
            if family == "ray3d" else chip_smoke.DELTA
        data = interop.data_to_torch(chip_smoke.rigid_data(rng, family, n, geometry),
                                     device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        coords, p, n_fit, cols = fs.sweep_inputs(family, data, gen)
        hyp = groups * n_fit
        print(f"{family} ({est}): {groups} groups x {n_fit} lanes x {cols} columns")
        times = {k: [] for k in PER_THREAD}
        results = {}
        for order in (PER_THREAD, PER_THREAD[::-1]):
            for k in order:
                kernels.FUSED_SWEEPS[family] = variants[family, k]
                full = timer.ms(lambda: fs.sweep_cuda(family, coords, p, n_fit, groups, cols,
                                                      delta), reps=20)
                one = timer.ms(lambda: fs.sweep_cuda(family, coords, p, n_fit, groups, 1, delta),
                               reps=20)
                times[k].append((full, one))
                c, prm, i = fs.sweep_cuda(family, coords, p, n_fit, groups, cols, delta)
                results[k] = (int(c), int(i), prm.cpu())
        for k in PER_THREAD:
            shape = chip_smoke.launch_shape(variants[family, k], hyp)
            runs = ", ".join(f"{full:.4f} / {one:.4f}" for full, one in times[k])
            print(f"  {k} per thread: {shape}; sweep / on 1 column ms: {runs}")
        first = results[PER_THREAD[0]]
        for k, (c, i, prm) in results.items():
            same = c == first[0] and i == first[1] and bool(torch.equal(prm, first[2]))
            print(f"  {k} per thread: count {c}, index {i}, same winner as "
                  f"{PER_THREAD[0]} per thread: {same}")
            chip_smoke.check(same, f"{family}: layouts pick different winners")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
