"""Plain references the benchmark holds the program to.

They import neither ``jax`` nor the JAX package nor anything of the
program: only numpy, torch and the benchmark's own data.
"""
