"""The plain float64 PyTorch reference the benchmark judges the program
by. It imports nothing of the program under test."""
