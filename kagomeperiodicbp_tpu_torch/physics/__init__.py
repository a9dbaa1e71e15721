from . import hamiltonians, metrics, pauli

__all__ = ["hamiltonians", "metrics", "pauli"]
