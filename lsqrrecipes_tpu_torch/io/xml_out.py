"""``<precomputed_transform>`` XML result files (counterpart of
``lsqrrecipes_tpu/io/xml_out.py``).

The reference's US-calibration examples persist the estimated image-to-probe
transform as a small XML document: a description, the computation date, and
the scaled 3x4 calibration matrix
``[m_x R3(:,0) | m_y R3(:,1) | R3(:,2) | t3]`` with the mean reprojection
error as an attribute (``examples/planeUSCalibration.cxx:185-219``,
``crosswireUSCalibration.cxx:185-211``, ``pointerUSCalibration.cxx:218-244``).
Values may be numbers, numpy arrays or tensors on any device.
"""

import time


def write_precomputed_transform(path, description, transform, estimation_error):
    """Write the reference-format result file.

    ``transform``: ``[3, 4]`` array-like (scaled rotation columns | t3);
    ``estimation_error``: mean distance over the data (the reference's
    ``meanErr``).  Ten fixed decimals, as the reference notes is "enough to
    retain accuracy in ASCII format".
    """
    rows = [[float(v) for v in row] for row in transform]
    if len(rows) != 3 or any(len(r) != 4 for r in rows):
        raise ValueError("transform must be 3x4")
    stamp = time.strftime("%Y %b %d %H:%M:%S")
    with open(path, "w") as out:
        out.write('<?xml version="1.0" encoding="ISO-8859-1"?>\n\n\n\n')
        out.write("<precomputed_transform>\n\n")
        out.write(f"\t<description>\n\t{description}\n\t</description>\n\n")
        out.write(f"\t<computation_date>\n\t{stamp}\n\t</computation_date>\n\n")
        out.write(
            f'\t <transformation estimation_error="{float(estimation_error):.10f}">\n'
        )
        for row in rows:
            out.write("\t" + "\t".join(f"{v:.10f}" for v in row) + "\n")
        out.write("\t</transformation>\n\n")
        out.write("</precomputed_transform>\n")


def calibration_transform_from_params(t3, c1, c2, c3):
    """Assemble the 3x4 scaled calibration matrix from the derived parameter
    slices (``m_x R3(:,0)``, ``m_y R3(:,1)``, ``R3(:,2)``, ``t3``)."""
    return [
        [float(c1[i]), float(c2[i]), float(c3[i]), float(t3[i])] for i in range(3)
    ]
