"""Layered SPMD repair on an emulated ``(pod, node)`` mesh (one card)."""
