"""Example programs of the port, one per example of the JAX package's
``examples/`` (which mirror the reference's ``examples/``).  Each is a
module with ``main(argv=None) -> int`` and ``--device`` (default ``cuda``):

    python -m lsqrrecipes_tpu_torch.examples.sphere_estimation [--device cpu]

They print the same banners and reports as the JAX examples and write the
same ``.iv`` scenes and XML results into the working directory.
"""
