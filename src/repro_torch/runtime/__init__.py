"""Runtime spine of the port: the execution guard layer (``guard``: error
taxonomy, degradation ladder, numerics policy), its deterministic
fault-injection harness (``chaos``), and the KronScope telemetry spine
(``telemetry``: spans, metrics, exports; ``events``: JSONL sink + shared
logger), the model stack's sharding rules (``sharding``), and the cost
counting of the dry-run tooling (``hlo_cost``: FLOPs, bytes and collectives
of an eager step; ``hlo_analysis``: collective kinds and payloads)."""
