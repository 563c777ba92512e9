"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything about a cell is found by name:

* ``configs/<config>.json`` — the deployment or model, its source, its
  cuts (``reduced``), what was assumed, and the limits of ``correct``;
  its ``system`` names the module ``systems/<system>.py`` that runs it;
* ``traffic/<traffic>.json`` — the mix's parameters;
* ``layers/<metric>.py`` — one reader per per-layer metric.

A new cell reports the end-to-end metrics the benchmark has: one without
``workloads`` belongs to every cell.  It comes in by new files and new
entries alone (its configuration file and ``configs`` entry, its
``workloads`` entry, and per-layer metrics of its own whose ``workloads``
name it); every per-layer metric carries such a list.  A later cell that
cannot report a list-free end-to-end metric gives that metric the list of
the accepted cells that report it, in the change that adds the cell
(``harness.cell_metrics``).

The yardstick lives here and nowhere in the program: the seeded fans of
lanes (``systems/soa.py``), the byte counts (``counts.py``), the H100
peaks (``peaks.py``), the trace reduction (``tracing.py``), and the plain
reference of ``correct`` with the comparison (``ref_soa/``,
``systems/soa.py``).  Nothing here imports ``jax``
or the JAX package ``repro``.
"""
