"""Runtime spine of the port: the execution guard layer (``guard``: error
taxonomy, degradation ladder, numerics policy), its deterministic
fault-injection harness (``chaos``), and the KronScope telemetry spine
(``telemetry``: spans, metrics, exports; ``events``: JSONL sink + shared
logger)."""
