"""The plain reference and the comparison that decides ``correct``.

Imports nothing of the program (``repro_torch``) and neither ``jax`` nor
the JAX package: only the Python standard library and NumPy.
"""
