"""Launchers of the port: :mod:`.serve` (LM serving and SNP trace
serving), :mod:`.train` (training) and :mod:`.mesh` (the production
mesh, :func:`make_production_mesh`, exported here as the reference
exports it; :mod:`.mesh` imports nothing at load time, so importing this
package touches no device and starts no process group)."""

from .mesh import make_production_mesh

__all__ = ["make_production_mesh"]
