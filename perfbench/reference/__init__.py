"""Plain PyTorch and NumPy references of what the program computes; they
import nothing of the program."""
