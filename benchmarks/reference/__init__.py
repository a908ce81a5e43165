"""Plain references, one per job kind. They import torch alone: nothing of
the program, so a fault of the program cannot hide in its own check."""
