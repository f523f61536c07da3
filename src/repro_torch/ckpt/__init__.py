"""Distributed checkpoint save and weights-only restore of the port."""
