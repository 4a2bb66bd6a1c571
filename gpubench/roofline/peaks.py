"""Peak rates by card name (``torch.cuda.get_device_name()``): f32
operations per second outside the tensor cores, and memory bytes per
second.  NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit."""

PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 3.35e12)}
