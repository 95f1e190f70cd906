"""Layers of the ported dense decoder."""
