"""Training of the port: OneCycle schedule, AdamW trainer, checkpoints."""
