"""The plain reference of the nested PSVI step: plain PyTorch, nothing of
the program."""
