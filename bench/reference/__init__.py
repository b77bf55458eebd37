"""The plain reference the benchmark judges the program by (float32
torch; imports nothing of the program)."""
