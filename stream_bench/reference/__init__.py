"""The plain NumPy reference of the stream simulator and the frozen
generators of its inputs; imports nothing of the program."""
