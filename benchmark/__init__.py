"""The benchmark of the PyTorch and CUDA port (document_search_engine_tpu_torch).

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` (run.py); gen/ draws the
inputs from the seed, setups/ builds a configuration's index (one module
a `setup`, single.py without one), loops/ drives a mix (one module a
`loop`), reference/ holds the plain references that decide `correct` (one
module a scoring kind), control.py their control, roofline.py the
least-time counts, trace.py reads the profiler's trace, metrics/ holds
one reader for each per-layer metric, configs/ and traffic/ the
deployments and mixes; registry.py finds each by name.
"""
