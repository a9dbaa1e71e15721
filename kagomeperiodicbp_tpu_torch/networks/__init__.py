from .graph import TNGraph, build_block_graph, attach_messages, full_graph, message_bond_profile
from .unit_cell import UnitCell, fused_tensor, FLAVORS

__all__ = [
    "TNGraph", "build_block_graph", "attach_messages", "full_graph",
    "message_bond_profile", "UnitCell", "fused_tensor", "FLAVORS",
]
