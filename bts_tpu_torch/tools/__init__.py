"""Scripts of the port: the benchmarks (``bench``, ``bench_train``,
``bench_zoo``, ``bench_lpg``, the counterparts of ``bench.py`` and
``scripts/bench_*.py``), the profilers (they need a CUDA card), the
data-parallel dry run and the reference-accuracy reproduction
(``reproduce_reference``)."""
