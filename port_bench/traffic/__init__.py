"""Traffic: mixes of parameters (``mixes/<name>.json``) and the one
generator that reads them (:mod:`port_bench.traffic.generator`)."""
