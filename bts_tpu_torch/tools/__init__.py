"""Scripts of the port: the profilers (they need a CUDA card) and the
reference-accuracy reproduction (``reproduce_reference``)."""
