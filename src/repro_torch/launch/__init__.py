"""Launchers of the port: :mod:`.serve` (LM serving)."""
