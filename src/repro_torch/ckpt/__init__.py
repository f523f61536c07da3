"""Checkpointing of the port: distributed saves (raw or coded, sync or
async), the manager and policy, and restore of the weights or the full
train state."""
