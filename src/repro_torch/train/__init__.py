"""Training (port of ``repro.train``): data, AdamW, the train step and the
trainer, on one explicit device."""
