"""The plain reference: FOLD's signatures and an exact online pipeline in
plain PyTorch, worked out from the inputs alone. Imports nothing of the
program."""
