"""Plain PyTorch references the benchmark judges the program against."""
