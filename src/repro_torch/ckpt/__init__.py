"""Checkpointing of the port: distributed saves (raw or coded, sync or
async), the manager and policy, restore of the weights or the full train
state (DIRECT, RESHARD_STREAM or VIA_UCP), and the export of a step as UCP
atoms."""
