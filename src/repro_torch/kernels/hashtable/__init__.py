"""Hash-table probe kernels: ``csrc/hashtable.cu`` (H1, lookup; H2,
claim-insert), wrapper :mod:`.ops`, plain versions :mod:`.ref`.  They
replace no Pallas kernel: they are the port's counterparts of the
reference's probe ``while_loop``s, so the BFS level needs no host read.
"""

from .ops import claim_, lookup
from .ref import claim_ref, lookup_ref

__all__ = ["lookup", "claim_", "lookup_ref", "claim_ref"]
