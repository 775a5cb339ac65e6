"""Training: losses, AdamW and the EdgeBERT two-phase trainer (paper Fig. 6)."""
