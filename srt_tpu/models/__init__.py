"""Renderers: the wavefront path tracer and the CPU oracle."""
