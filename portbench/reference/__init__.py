"""The plain reference the output check holds the program to: plain torch,
importing neither JAX, nor the JAX package, nor anything of the port."""
