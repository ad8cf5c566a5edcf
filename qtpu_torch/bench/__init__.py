"""Measurement tooling of the port (port of qtpu/bench): graph timers and
the slope fit (``timing``), append-only receipts (``receipts``), profiler
traces and the engines' scopes (``profile``), the per-layer roofline table
(``tracing``), DP scaling over a world of ranks (``scaling``) and the 1→N
projection from a TP forward's collectives (``scaling_projection``).
qtpu's ``overlap`` (an XLA ahead-of-time compile for a TPU topology) has
no counterpart (ROADMAP.md A13)."""
