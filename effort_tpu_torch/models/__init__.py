"""Decode forward pass, weight synthesis and the generation engine."""
