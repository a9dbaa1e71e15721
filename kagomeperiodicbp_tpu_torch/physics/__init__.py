from . import hamiltonians, metrics, operators, pauli

__all__ = ["hamiltonians", "metrics", "operators", "pauli"]
