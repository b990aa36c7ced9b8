"""Plain decoders the benchmark holds the program's pixels against: NumPy
and Python only, no import of the program or of JAX."""
