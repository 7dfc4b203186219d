"""The port's benchmark harness: cells, inputs, sinks, traces, rooflines
and the comparison that decides ``correct``. Driven by the data files
beside it (``BENCHMARK.json``, ``configs/``, ``traffic/``, ``cells/``,
``metrics/``, ``kernel_names.json``)."""
