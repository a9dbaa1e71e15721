"""The Kagome block's geometry and plans, copied from the JAX package (see each file's head)."""
