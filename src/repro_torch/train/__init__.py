"""Host-side per-series state (what serving needs of the training package)."""
