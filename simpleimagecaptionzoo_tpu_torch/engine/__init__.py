"""Decode entry points."""
