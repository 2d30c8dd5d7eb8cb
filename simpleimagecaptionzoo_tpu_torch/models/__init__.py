"""Captioner families and the layer library."""
