"""Per-layer metrics: one module per metric of ``BENCHMARK.json``, found by
its name. Each has ``WHEN`` (``"before_trace"``: read in the traced run
after the measured window and before the profiler starts;
``"after_trace"``: read from the profiler's trace) and ``read(ctx)``, which
returns the value in the metric's unit, or None where the run has nothing
to read (every reader on the CPU, which has no device numbers); the harness
then leaves the metric out of the line. ``ctx`` is
``mdbench.run.Context``."""
