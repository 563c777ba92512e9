"""Frozen plain reference of the SoA lanes, for the benchmark's
``correct``.

A copy of the port's event-driven engine (``core/sim/engine.py``, the
scalar semantics that the SoA round loop approximates in rounds of
``dt``) and of the host half it needs: the workload stack, the GHA
schedule compile, the runtime policies and replanner, the per-seed
NumPy sampler, the scenario modes and scripts, the metrics registry.
Its imports point here, and it imports nothing of the program: later
changes to the program are judged against this copy.  It holds no part
of the SoA engine (no problem build, round loop, allocator or report
assembly) and builds no kernel.  :func:`h100bench.ref_soa.lanes.reference_lanes`
is the entry.
"""
