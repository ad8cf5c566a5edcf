"""The plain reference of every configuration: plain PyTorch, importing
nothing of the system under test."""
