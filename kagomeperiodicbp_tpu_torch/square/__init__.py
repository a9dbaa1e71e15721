"""Square-lattice BlockBP + ITE (counterpart of kagomeperiodicbp_tpu/square:
the reference's legacy squareITE.py, on the shared plan compiler and
executor)."""
from .lattice import SquareSide, build_square_graph, full_square_graph
from .algo import (
    belief_propagation,
    initial_messages,
    measure_energy,
    pair_expectation,
    simple_update,
)

__all__ = [
    "SquareSide", "build_square_graph", "full_square_graph",
    "belief_propagation", "initial_messages", "measure_energy",
    "pair_expectation", "simple_update",
]
