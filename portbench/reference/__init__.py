"""The plain reference that decides whether a run of the program is
correct: plain PyTorch and NumPy, importing nothing of the program."""
