"""The benchmark of the PyTorch/CUDA port (``sjd_tpu_torch``).

One command runs one cell once::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, the
configurations and the metrics; each of them is a file of its own under
this folder (``configs/``, ``workloads/``, ``traffic/mixes/``,
``metrics/``), found by its name. Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""
