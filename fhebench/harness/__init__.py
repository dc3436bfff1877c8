"""The harness: it reads the cell from BENCHMARK.json, builds the engine
and the traffic from the seed, measures the window, reduces the trace and
judges the answers. Per-layer metrics, traffic mixes, configurations and
kernel formulas are files of their own, found by name."""
