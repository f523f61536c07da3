"""Elastic capacity: mesh proposals and in-process recovery (port of
``repro.elastic``)."""

from .planner import param_count, propose_mesh, state_bytes_per_chip
from .resume import ElasticEvent, hot_recover, rebuild_on, reform_group, survivor_plan

__all__ = [
    "ElasticEvent", "hot_recover", "param_count", "propose_mesh", "rebuild_on", "reform_group",
    "state_bytes_per_chip", "survivor_plan",
]
