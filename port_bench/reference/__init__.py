"""The plain references that decide ``correct``: plain PyTorch in complex128,
importing nothing of the program. They take only the operands the harness
made and the answers the program returned, and judge those answers."""
