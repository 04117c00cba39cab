"""Launchers of the port: :mod:`.serve` (LM serving and SNP trace
serving), :mod:`.train` (training) and :mod:`.mesh` (the production
mesh)."""
